"""The port's composed attention: its plain version against the JAX
package's fused Pallas kernel (interpret mode) and the direct masked
attention, ``composed_qkvo`` against JAX's, the CPU dispatch of the wrapper,
and, on a card, the CUDA kernel against the plain version.

The host with the card has no JAX, so JAX is imported by the tests that use
it and the card's tests run without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_composed_attn.py
"""
import math

import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.ops.attention import chunked_attention, composed_qkvo
from vidsgg_big_tpu_torch.ops.composed_attn import (composed_attention,
                                                    composed_attention_plain,
                                                    fused_composed_attention)

# tests/test_pallas_attention.py's narrow shape: 4 heads of 8 at d = 64 (the
# plain version takes any d; only the CUDA kernel needs d = 128)
H, HD = 4, 8
D = H * HD


@pytest.fixture(scope="module")
def jax_ops():
    import jax.numpy as jnp
    from vidsgg_big_tpu.ops import attention, pallas_attention
    return jnp, attention, pallas_attention


def _weights(seed, d=D, h=H):
    hd = d // h
    r = np.random.default_rng(seed)
    return dict(
        wq=r.normal(0, 0.3, (d, h, hd)), bq=r.normal(0, 0.1, (h, hd)),
        wk=r.normal(0, 0.3, (d, h, hd)), wv=r.normal(0, 0.3, (d, h, hd)),
        bv=r.normal(0, 0.1, (h, hd)), wo=r.normal(0, 0.3, (h, hd, d)),
        bo=r.normal(0, 0.1, (d,)))


def _inputs(seed, b, t, d=D, masked_row=False):
    r = np.random.default_rng(seed + 100)
    x = r.normal(size=(b, t, d)).astype(np.float32)
    mask = r.random((b, t)) < 0.8
    mask[:, 0] = True
    if masked_row:
        mask[-1] = False                 # a padded row: no valid key
    return x, mask


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _port_composites(w):
    return composed_qkvo(*(_t(w[k]) for k in ("wq", "bq", "wk", "wv", "wo",
                                              "bv", "bo")))


def test_composed_qkvo_matches_jax(jax_ops):
    jnp, attention, _ = jax_ops
    w = _weights(0)
    ref = attention.composed_qkvo(*(jnp.asarray(w[k], jnp.float32) for k in (
        "wq", "bq", "wk", "wv", "wo", "bv", "bo")))
    for got, want in zip(_port_composites(w), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# float32: sums in another order only; bfloat16: qh, vt, A and the output
# are rounded to bf16 (8 significant bits) in both packages, and a
# last-bit difference in a float32 sum can flip one rounding
TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 256])
def test_plain_matches_jax_fused_kernel(jax_ops, dtype, t):
    """The port's fused_composed_attention (plain version on the CPU)
    against the JAX Pallas kernel in interpret mode, a fully masked row
    included (both give the uniform mean of vt there)."""
    jnp, attention, pallas_attention = jax_ops
    w = _weights(1)
    x, mask = _inputs(1, 3, t, masked_row=True)
    jdt = getattr(jnp, dtype)
    comp = attention.composed_qkvo(*(jnp.asarray(w[k], jnp.float32) for k in (
        "wq", "bq", "wk", "wv", "wo", "bv", "bo")))
    want = pallas_attention.fused_composed_attention(
        jnp.asarray(x, jdt), jnp.asarray(mask), *comp, hd=HD,
        interpret=True)
    got = fused_composed_attention(
        _t(x, getattr(torch, dtype)), torch.from_numpy(mask),
        *_port_composites(w), hd=HD)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


def test_plain_matches_direct_attention():
    """Composed = per-head projections + masked softmax attention + output
    projection, on the valid rows (float32, 1e-4); b_k drops out."""
    w = _weights(2)
    x, mask = _inputs(2, 4, 128)
    xt, m = _t(x), torch.from_numpy(mask)
    got = fused_composed_attention(xt, m, *_port_composites(w), hd=HD)
    proj = lambda wn, bn: torch.einsum("btc,chd->bthd", xt, _t(w[wn])) + \
        (_t(w[bn]) if bn else 0.0)
    bk = torch.from_numpy(np.random.default_rng(9).normal(
        size=(H, HD)).astype(np.float32))
    o = chunked_attention(proj("wq", "bq"), proj("wk", None) + bk,
                          proj("wv", "bv"), m, chunk=2)
    want = torch.einsum("bqhd,hdc->bqc", o, _t(w["wo"])) + _t(w["bo"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_plain_chunks_rows():
    """The plain version gives the same result however its rows are
    chunked (the chunk follows PLAIN_LOGIT_BYTES)."""
    from vidsgg_big_tpu_torch.ops import composed_attn
    rng = np.random.default_rng(3)
    qh, vt = (_t(rng.normal(size=(5, H, 128, D))) for _ in range(2))
    x = _t(rng.normal(size=(5, 128, D)))
    bias = _t(np.where(rng.random((5, 128)) < 0.8, 0.0, -1e30))
    whole = composed_attention_plain(qh, x, vt, bias, 0.3)
    old = composed_attn.PLAIN_LOGIT_BYTES
    composed_attn.PLAIN_LOGIT_BYTES = 4 * H * 128 * 128 * 2   # 2 rows
    try:
        chunked = composed_attention_plain(qh, x, vt, bias, 0.3)
    finally:
        composed_attn.PLAIN_LOGIT_BYTES = old
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the plain version and count no launch; dropout
    raises (grounding training is not ported); other devices raise."""
    rng = np.random.default_rng(4)
    qh, vt = (_t(rng.normal(size=(2, H, 64, D))) for _ in range(2))
    x = _t(rng.normal(size=(2, 64, D)))
    bias = torch.zeros(2, 64)
    before = composed_attention.launches
    out = composed_attention(qh, x, vt, bias, 0.5)
    assert composed_attention.launches == before
    torch.testing.assert_close(
        out, composed_attention_plain(qh, x, vt, bias, 0.5), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="next slice"):
        composed_attention(qh, x, vt, bias, 0.5, dropout=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        composed_attention(qh.to("meta"), x.to("meta"), vt.to("meta"),
                           bias.to("meta"), 0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(r, t, dtype, device, seed=0):
    """Grounding-width operands (8 heads, d = 128) with masked keys and,
    for r > 1, one fully masked row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qh = torch.randn(r, 8, t, 128, generator=g) * 0.1
    x = torch.randn(r, t, 128, generator=g)
    vt = torch.randn(r, 8, t, 128, generator=g) * 0.2
    valid = torch.rand(r, t, generator=g) < 0.8
    valid[:, 0] = True
    if r > 1:
        valid[-1] = False
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)
    return [a.to(device=device, dtype=dtype) for a in (qh, x, vt)] + [
        bias.to(device)]


# kernel vs plain on the card: float32 differs in summation order only;
# in bfloat16 each attention weight is rounded to bf16 once in both, the
# plain version after normalising and the kernel's online softmax before
# (2^-9 relative either way)
CARD_TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r,t", [(1, 128), (4, 128), (3, 512), (2, 1024)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, r, t):
    qh, x, vt, bias = _card_inputs(r, t, dtype, cuda_device)
    before = composed_attention.launches
    out = composed_attention(qh, x, vt, bias, 0.25)
    torch.cuda.synchronize()
    assert composed_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    want = composed_attention_plain(qh, x, vt, bias, 0.25)
    torch.testing.assert_close(out, want, **CARD_TOLS[dtype])


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    qh, x, vt, bias = _card_inputs(2, 128, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="d = 128"):
        composed_attention(qh[..., :64].contiguous(), x[..., :64].contiguous(),
                           vt[..., :64].contiguous(), bias, 0.25)
    with pytest.raises(ValueError, match="multiple of 64"):
        composed_attention(qh[:, :, :96].contiguous(), x[:, :96].contiguous(),
                           vt[:, :, :96].contiguous(),
                           bias[:, :96].contiguous(), 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        composed_attention(qh.bfloat16(), x, vt, bias, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        composed_attention(qh.transpose(2, 3).contiguous().transpose(2, 3), x,
                           vt, bias, 0.25)
    with pytest.raises(NotImplementedError, match="next slice"):
        composed_attention(qh, x, vt, bias, 0.25, dropout=0.1)
