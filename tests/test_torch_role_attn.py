"""The port's role attention: its plain version against the JAX package's
reference and its Pallas kernel (interpret mode), the CPU dispatch of the
wrapper, and, on a card, the CUDA kernel against the plain version.

The host with the card has no JAX, so JAX is imported by the tests that use
it and the card's tests run without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_role_attn.py
"""
import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.ops.role_attn import (role_attention,
                                                role_attention_plain)


@pytest.fixture(scope="module")
def jax_ops():
    import jax.numpy as jnp
    from vidsgg_big_tpu.ops import pallas_role_attn
    return jnp, pallas_role_attn


# (B, Q, N, Dh, De): tests/test_ops.py's shape, N=13 (no multiple of 8),
# and a narrow exp2-like shape
SHAPES = [(2, 16, 8, 32, 24), (3, 10, 13, 16, 20), (2, 24, 50, 32, 64)]


def _inputs(b, q, n, dh, de, seed=20):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 0.3, (b, 2, q, dh)).astype(np.float32)
    e = rng.normal(0, 0.3, (b, 2, n, dh)).astype(np.float32)
    enco = rng.normal(0, 0.5, (b, n, de)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.3
    mask[0, 0] = True
    if b > 1:
        mask[-1] = False                # a padded video: no valid tracklet
    return p, e, enco, mask


def _plain(p, e, enco, mask, dim_enti):
    att, val = role_attention_plain(*(torch.from_numpy(x) for x in (
        p, e, enco, mask)), dim_enti=dim_enti)
    return att.numpy(), val.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference(jax_ops, shape):
    jnp, ops = jax_ops
    p, e, enco, mask = _inputs(*shape)
    de = shape[-1]
    att_r, val_r = ops.role_attention_reference(
        *(jnp.asarray(x) for x in (p, e, enco, mask)), dim_enti=de)
    att, val = _plain(p, e, enco, mask, de)
    np.testing.assert_allclose(att, np.asarray(att_r), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(val, np.asarray(val_r), rtol=1e-4, atol=1e-5)
    assert not att[-1].any() and not val[-1].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(jax_ops, shape):
    """tests/test_ops.py's tolerances against the TPU kernel itself."""
    jnp, ops = jax_ops
    p, e, enco, mask = _inputs(*shape)
    de = shape[-1]
    att_k, val_k = ops.role_attention(
        *(jnp.asarray(x) for x in (p, e, enco, mask)), dim_enti=de,
        interpret=True)
    att, val = _plain(p, e, enco, mask, de)
    np.testing.assert_allclose(att, np.asarray(att_k), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(val, np.asarray(val_k), rtol=1e-4, atol=1e-5)


def test_dim_enti_scales_the_logits(jax_ops):
    """The logit scale is 1/sqrt(dim_enti), not 1/sqrt(Dh)."""
    jnp, ops = jax_ops
    p, e, enco, mask = _inputs(2, 8, 6, 16, 32)
    att_a, _ = _plain(p, e, enco, mask, 32)
    att_b, _ = _plain(p, e, enco, mask, 16)
    att_r, _ = ops.role_attention_reference(
        *(jnp.asarray(x) for x in (p, e, enco, mask)), dim_enti=32)
    np.testing.assert_allclose(att_a, np.asarray(att_r), rtol=1e-5,
                               atol=1e-7)
    assert np.abs(att_a - att_b).max() > 1e-4


def test_wrapper_uses_plain_version_on_cpu():
    """CPU tensors take the plain version (cast to float32) and count no
    kernel launch."""
    p, e, enco, mask = (torch.from_numpy(x) for x in _inputs(*SHAPES[1]))
    before = role_attention.launches
    att, val = role_attention(p.double(), e, enco, mask, dim_enti=20)
    att_p, val_p = role_attention_plain(p, e, enco, mask, dim_enti=20)
    assert role_attention.launches == before
    assert att.dtype == val.dtype == torch.float32
    torch.testing.assert_close(att, att_p, rtol=0, atol=0)
    torch.testing.assert_close(val, val_p, rtol=0, atol=0)


def test_wrapper_rejects_other_devices_and_dtypes():
    p, e, enco, mask = (torch.from_numpy(x) for x in _inputs(*SHAPES[0]))
    with pytest.raises(ValueError, match="unsupported device"):
        role_attention(p.to("meta"), e.to("meta"), enco.to("meta"),
                       mask.to("meta"), dim_enti=24)
    with pytest.raises(TypeError, match="floating point"):
        role_attention(p.to(torch.int32), e, enco, mask, dim_enti=24)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 50), (8, 50), (32, 50), (8, 180),
                                 (3, 13)])
def test_cuda_kernel_matches_plain(cuda_device, b, n):
    """The CUDA kernel against the plain version on the card, at exp2 width
    (Q=192, Dh=256, De=512) with padded videos and masked tracklets."""
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(b, 192, n, 256, 512))
    before = role_attention.launches
    att, val = role_attention(p, e, enco, mask, dim_enti=512)
    torch.cuda.synchronize()
    assert role_attention.launches == before + 1
    att_p, val_p = role_attention_plain(p, e, enco, mask, dim_enti=512)
    torch.testing.assert_close(att, att_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(val, val_p, rtol=1e-4, atol=1e-5)
    if b > 1:
        assert not att[-1].any() and not val[-1].any()


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    """Shape and contiguity are checked before the launch; an N whose
    shared memory exceeds the card's limit fails the launch and raises,
    and the next good launch is not blamed for it."""
    good = [torch.from_numpy(x).to(cuda_device)
            for x in _inputs(2, 192, 50, 256, 512)]
    p, e, enco, mask = good
    with pytest.raises(ValueError, match="do not agree"):
        role_attention(p, e[:, :, :40], enco, mask, dim_enti=512)
    with pytest.raises(ValueError, match="contiguous"):
        role_attention(p.transpose(2, 3).contiguous().transpose(2, 3), e,
                       enco, mask, dim_enti=512)
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(1, 32, 600, 64, 64))
    before = role_attention.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        role_attention(p, e, enco, mask, dim_enti=64)
    assert role_attention.launches == before
    role_attention(*good, dim_enti=512)
    torch.cuda.synchronize()
    assert role_attention.launches == before + 1
