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

from vidsgg_big_tpu_torch.ops import role_attn as ra
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


def _layer_views(b, q, n, dh, de, seed=20):
    """The decoder layer's operands: p and e the role halves of (B, Q, 2 Dh)
    and (B, N, 2 Dh) projections as strided views (layers.py), and the same
    halves stacked as numpy arrays for the JAX side."""
    p, e, enco, mask = _inputs(b, q, n, dh, de, seed)
    pred2att = np.concatenate([p[:, 0], p[:, 1]], axis=-1)
    enti2att = np.concatenate([e[:, 0], e[:, 1]], axis=-1)
    views = (torch.from_numpy(pred2att).unflatten(-1, (2, dh)).transpose(1, 2),
             torch.from_numpy(enti2att).unflatten(-1, (2, dh)).transpose(1, 2),
             torch.from_numpy(enco), torch.from_numpy(mask))
    return views, (p, e, enco, mask)


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


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_on_layer_views_matches_jax_reference(jax_ops, shape):
    """The plain version takes the layer's strided views as they are and
    matches the JAX reference on the stacked halves."""
    jnp, ops = jax_ops
    views, arrays = _layer_views(*shape)
    assert not views[0].is_contiguous() and not views[1].is_contiguous()
    de = shape[-1]
    att_r, val_r = ops.role_attention_reference(
        *(jnp.asarray(x) for x in arrays), dim_enti=de)
    att, val = role_attention_plain(*views, dim_enti=de)
    np.testing.assert_allclose(att.numpy(), np.asarray(att_r), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(val.numpy(), np.asarray(val_r), rtol=1e-4,
                               atol=1e-5)


def test_wrapper_takes_views_and_bool_mask_on_cpu():
    """Views and a bool mask on the CPU take the plain version as they are:
    no copy, no cast of the mask, no launch."""
    views, arrays = _layer_views(*SHAPES[2])
    assert views[3].dtype == torch.bool
    before = role_attention.launches
    att, val = role_attention(*views, dim_enti=64)
    att_p, val_p = role_attention_plain(
        *(torch.from_numpy(x) for x in arrays), dim_enti=64)
    assert role_attention.launches == before
    torch.testing.assert_close(att, att_p, rtol=0, atol=0)
    torch.testing.assert_close(val, val_p, rtol=0, atol=0)


@pytest.mark.parametrize("b,q,de,sms,want", [
    (8, 192, 512, 132, 1),     # exp2: 96 tiles, 192 blocks would not fit
    (4, 192, 512, 132, 2),     # VidOR stage A: 48 tiles
    (1, 192, 512, 132, 4),     # 12 tiles, capped at MAX_SPLITS
    (32, 192, 512, 132, 1),
    (2, 192, 256, 132, 2),     # a third split would leave 64 columns
    (3, 10, 20, 132, 1)])
def test_de_splits_fills_the_card(b, q, de, sms, want):
    assert ra.de_splits(b, q, de, sms) == want


def test_kernel_strides_take_layer_views_and_refuse_others():
    """The strides the kernel is given: the layer's views as they are (a
    size-1 dimension's stride as 0), and a ValueError naming the strides
    for a layout whose rows it cannot read."""
    views, _ = _layer_views(1, 16, 8, 32, 24)
    p, e, enco = views[:3]
    assert ra._kernel_strides("p", p) == [0, 32, 64]
    assert ra._kernel_strides("e", e) == [0, 32, 64]
    assert ra._kernel_strides("enco", enco) == [0, 24]
    with pytest.raises(ValueError, match="unsupported strides"):
        ra._kernel_strides("p", p.transpose(2, 3))
    with pytest.raises(ValueError, match="unsupported strides"):
        ra._kernel_strides("enco", torch.zeros(2, 8, 30)[..., 1:27])


def test_turns_tool_feeds_the_layers_views():
    """tools/role_attn_turns times the kernel on the operands the decoder
    layer gives it: strided halves of the projections, a bool mask with a
    padded video; its other checkouts and forced splits parse."""
    from vidsgg_big_tpu_torch.tools import role_attn_turns as turns
    p, e, enco, mask = turns.layer_inputs(2, 13, device="cpu")
    assert p.shape == (2, 2, turns.Q, turns.DH) and not p.is_contiguous()
    assert e.shape == (2, 2, 13, turns.DH) and not e.is_contiguous()
    assert enco.shape == (2, 13, turns.DE) and mask.dtype == torch.bool
    assert mask[0].any() and not mask[-1].any()
    assert ra._kernel_strides("p", p) == [turns.Q * 2 * turns.DH, turns.DH,
                                          2 * turns.DH]
    args = turns.parse_args(["parent", "--splits", "1", "2"])
    assert args.other == ["parent"] and args.splits == [1, 2]
    assert turns.parse_args([]).other == []


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


def _card_check(p, e, enco, mask, dim_enti, padded=True):
    before = role_attention.launches
    att, val = role_attention(p, e, enco, mask, dim_enti=dim_enti)
    torch.cuda.synchronize()
    assert role_attention.launches == before + 1
    att_p, val_p = role_attention_plain(p, e, enco, mask, dim_enti=dim_enti)
    torch.testing.assert_close(att, att_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(val, val_p, rtol=1e-4, atol=1e-5)
    if padded:
        assert not att[-1].any() and not val[-1].any()
    return att, val


@pytest.mark.gpu
@pytest.mark.parametrize("n", [13, 50, 64, 180, 192])
@pytest.mark.parametrize("b", [1, 4, 8, 32])
def test_cuda_kernel_matches_plain(cuda_device, b, n):
    """The CUDA kernel against the plain version on the card, at exp2 width
    (Q=192, Dh=256, De=512) with padded videos and masked tracklets, at
    every split the launch picks for these batches."""
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(b, 192, n, 256, 512))
    _card_check(p, e, enco, mask, 512, padded=b > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("q", [100, 7])
def test_cuda_kernel_ragged_query_tile(cuda_device, q, splits):
    """Q not a multiple of the 16-row tile, at every split of De."""
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(3, q, 50, 256, 512))
    att, val = ra._launch(p, e, enco, mask, 512, splits=splits)
    torch.cuda.synchronize()
    att_p, val_p = role_attention_plain(p, e, enco, mask, dim_enti=512)
    torch.testing.assert_close(att, att_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(val, val_p, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_narrow_widths(cuda_device, shape):
    """Widths that fill no tile (Dh 16 or 32 of a 64-wide stage, De 20)."""
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(*shape))
    _card_check(p, e, enco, mask, shape[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(8, 50), (4, 64), (4, 192)])
def test_cuda_kernel_on_layer_views(cuda_device, b, n):
    """The layer's strided views and a bool mask go to the kernel as they
    are, and it matches the plain version on the same views."""
    views, _ = _layer_views(b, 192, n, 256, 512)
    views = [x.to(cuda_device) for x in views]
    assert not views[0].is_contiguous() and views[3].dtype == torch.bool
    _card_check(*views, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32])
def test_cuda_kernel_all_masked_video(cuda_device, dtype):
    """A video with no valid tracklet gives att = 0 and values = 0, no NaN,
    whatever the mask's dtype."""
    p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                        for x in _inputs(4, 192, 64, 256, 512))
    mask[1] = False
    att, val = _card_check(p, e, enco, mask.to(dtype), 512)
    assert not att[1].any() and not val[1].any()
    assert torch.isfinite(att).all() and torch.isfinite(val).all()


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    """Shapes and strides are checked before the launch, and so is N: one
    past the kernel's limit raises, naming the limit, and launches nothing;
    the limit itself runs."""
    good = [torch.from_numpy(x).to(cuda_device)
            for x in _inputs(2, 192, 50, 256, 512)]
    p, e, enco, mask = good
    with pytest.raises(ValueError, match="do not agree"):
        role_attention(p, e[:, :, :40], enco, mask, dim_enti=512)
    with pytest.raises(ValueError, match="unsupported strides"):
        role_attention(p.transpose(2, 3).contiguous().transpose(2, 3), e,
                       enco, mask, dim_enti=512)
    limit = ra.max_tracklets(ra._library(), 256)
    assert limit >= 420
    before = role_attention.launches
    for n, ok in ((limit + 1, False), (limit, True)):
        p, e, enco, mask = (torch.from_numpy(x).to(cuda_device)
                            for x in _inputs(1, 32, n, 256, 64))
        if ok:
            _card_check(p, e, enco, mask, 64, padded=False)
        else:
            with pytest.raises(ValueError, match=f"limit of {limit}"):
                role_attention(p, e, enco, mask, dim_enti=64)
            assert role_attention.launches == before
    role_attention(*good, dim_enti=512)
    torch.cuda.synchronize()
    assert role_attention.launches == before + 2
