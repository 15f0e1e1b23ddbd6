"""The port's composed attention: its plain forward and backward against the
JAX package's fused Pallas kernel (interpret mode, dropout 0: its PRNG is a
zero stub there) and the direct masked attention, ``composed_qkvo`` against
JAX's, the Philox keep-mask (known answers, determinism, realized rate),
dropout statistics, the CPU dispatch of the wrappers, the float32 kernels'
3xTF32 arithmetic emulated on the plain forward and backward, and, on a
card, the CUDA kernels against the plain versions.

The host with the card has no JAX, so JAX is imported by the tests that use
it and the card's tests run without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_composed_attn.py
"""
import math

import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.ops.attention import chunked_attention, composed_qkvo
from vidsgg_big_tpu_torch.ops.composed_attn import (
    ComposedAttention, composed_attention, composed_attention_backward,
    composed_attention_plain, composed_attention_plain_bwd,
    composed_attention_train, fused_composed_attention)
from vidsgg_big_tpu_torch.ops.philox import (attention_bits, attention_keep,
                                             drop_threshold, philox4x32_10)

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
    """CPU tensors take the plain versions and count no launch, dropout
    included (it needs the rows' seeds); other devices raise."""
    rng = np.random.default_rng(4)
    qh, vt = (_t(rng.normal(size=(2, H, 64, D))) for _ in range(2))
    x = _t(rng.normal(size=(2, 64, D)))
    bias = torch.zeros(2, 64)
    seeds = torch.tensor([5, -7], dtype=torch.int32)
    counters = (composed_attention, composed_attention_train,
                composed_attention_backward)
    before = [f.launches for f in counters]
    out = composed_attention(qh, x, vt, bias, 0.5)
    torch.testing.assert_close(
        out, composed_attention_plain(qh, x, vt, bias, 0.5), rtol=0, atol=0)
    dropped = composed_attention(qh, x, vt, bias, 0.5, dropout=0.1,
                                 seeds=seeds)
    torch.testing.assert_close(dropped, composed_attention_plain(
        qh, x, vt, bias, 0.5, 0.1, seeds), rtol=0, atol=0)
    assert not torch.equal(dropped, out)
    grads = composed_attention_backward(qh, x, vt, bias, seeds, None, x,
                                        0.5, 0.1)
    for g, w in zip(grads, composed_attention_plain_bwd(
            qh, x, vt, bias, x, 0.5, 0.1, seeds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="seeds"):
        composed_attention(qh, x, vt, bias, 0.5, dropout=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        composed_attention(qh.to("meta"), x.to("meta"), vt.to("meta"),
                           bias.to("meta"), 0.5)


# ---- Philox keep-mask -----------------------------------------------------

def test_philox_known_answers():
    """Random123's philox4x32-10 known-answer vectors (kat_vectors)."""
    got = [int(w) for w in philox4x32_10(0, 0, 0, 0, 0, 0)]
    assert got == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    got = [int(w) for w in philox4x32_10(
        0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344, 0xa4093822,
        0x299f31d0)]
    assert got == [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]
    ones = [int(w) for w in philox4x32_10(*([0xffffffff] * 6))]
    assert ones == [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]


def test_philox_mask_is_a_function_of_its_counter():
    """The same (seed, head, query, key) gives the same bits in any call
    and at any T (the forward, the backward and every bucket), and the 2 x 2
    word layout puts word 2 (q & 1) + (k & 1) at (q, k)."""
    seeds = torch.tensor([123, -9], dtype=torch.int32)
    full = attention_bits(seeds, 3, 16, 12)
    torch.testing.assert_close(attention_bits(seeds, 3, 16, 12), full,
                               rtol=0, atol=0)
    torch.testing.assert_close(attention_bits(seeds, 3, 6, 8),
                               full[:, :, :6, :8], rtol=0, atol=0)
    words = philox4x32_10(5 >> 1, 7 >> 1, 2, 0, (-9) & 0xFFFFFFFF, 0)
    assert int(full[1, 2, 5, 7]) == int(words[2 * (5 & 1) + (7 & 1)])
    assert not torch.equal(full[0], full[1])          # rows differ


def test_philox_realized_keep_rate():
    """Over 2**21 draws the kept share is within 4 sigma of 1 - thr/2**32,
    and the rescale is 1 / that share (``_drop_consts``)."""
    p = 0.1
    thr, inv = drop_threshold(p)
    keep = attention_keep(torch.arange(8, dtype=torch.int32), 8, 128, 256, p)
    q = 1.0 - thr / 2 ** 32
    sigma = math.sqrt(q * (1 - q) / keep.numel())
    assert keep.numel() >= 1 << 21
    assert abs(keep.float().mean().item() - q) < 4 * sigma
    assert inv == pytest.approx(1.0 / q, rel=1e-12)


# ---- backward against JAX, dropout -----------------------------------------

def _jax_grads(jax_ops, w, x, mask, dtype, cot):
    """jax.grad of <fused_composed_attention, cot> (interpret mode) with
    respect to x and the composites (wqk, wb, wvo, cb)."""
    import jax
    jnp, attention, pallas_attention = jax_ops
    jdt = getattr(jnp, dtype)
    comp = attention.composed_qkvo(*(jnp.asarray(w[k], jnp.float32) for k in (
        "wq", "bq", "wk", "wv", "wo", "bv", "bo")))

    def f(xx, cc):
        o = pallas_attention.fused_composed_attention(
            xx, jnp.asarray(mask), *cc, hd=HD, interpret=True)
        return (o.astype(jnp.float32) * cot).sum()
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(x, jdt), comp)


# float32: the same sums in another order.  bfloat16: qh, vt, A, ds and the
# gradients are rounded to bf16 in both packages, at the same points but
# after float32 sums taken in another order, so a last-bit difference
# before a rounding can move a value by one bf16 step (2^-8 relative)
GRAD_TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_grad(jax_ops, dtype):
    """The port's gradients through ComposedAttention (the plain backward
    on the CPU) against jax.grad through the JAX fused kernel in interpret
    mode, at dropout 0, with a fully masked row: x and the four
    composites."""
    w = _weights(6)
    x, mask = _inputs(6, 3, 128, masked_row=True)
    cot = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    want = _jax_grads(jax_ops, w, x, mask, dtype, cot)
    xt = _t(x, getattr(torch, dtype)).requires_grad_()
    comp = [c.requires_grad_() for c in _port_composites(w)]
    out = fused_composed_attention(xt, torch.from_numpy(mask), *comp, hd=HD)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = [xt.grad] + [c.grad for c in comp]
    import jax
    for name, g, wv in zip(("x", "wqk", "wb", "wvo", "cb"), got,
                           jax.tree_util.tree_leaves(want)):
        scale = max(1.0, float(np.abs(np.asarray(wv, np.float32)).max()))
        np.testing.assert_allclose(
            g.float().numpy() / scale, np.asarray(wv, np.float32) / scale,
            err_msg=name, **GRAD_TOLS[dtype])


def test_b_k_gradient_is_exactly_zero():
    """A QANet layer in train mode on the composed path (dropout on): b_k
    drops out of the composed function, so its slice of the packed
    in_proj_bias gets a gradient of exactly zero
    (pallas_attention.py:31-33); b_q, b_v and the weights get gradients."""
    from vidsgg_big_tpu_torch.models.grounding import QANetEncoderLayer
    torch.manual_seed(0)
    layer = QANetEncoderLayer(128, 4, 7, attn_bytes_budget=1 << 20).train()
    with torch.no_grad():
        layer.mh_attn.in_proj_weight.normal_(0, 0.05)
        layer.mh_attn.in_proj_bias.normal_(0, 0.1)
    x = torch.randn(8, 128, 128)
    mask = torch.arange(128)[None] < torch.tensor([128, 91] * 4)[:, None]
    calls = []
    from vidsgg_big_tpu_torch.models import grounding
    real = grounding.fused_composed_attention
    grounding.fused_composed_attention = \
        lambda *a, **k: calls.append(k["dropout"]) or real(*a, **k)
    try:
        out = layer(x, mask, generator=torch.Generator().manual_seed(1))
    finally:
        grounding.fused_composed_attention = real
    assert calls == [0.1]
    (out.float() ** 2).sum().backward()
    gb = layer.mh_attn.in_proj_bias.grad
    assert torch.count_nonzero(gb[128:256]) == 0
    assert gb[:128].abs().sum() > 0 and gb[256:].abs().sum() > 0
    assert layer.mh_attn.in_proj_weight.grad.abs().sum() > 0


def _dropout_case(seed=3, b=2, t=128):
    w = _weights(seed)
    x, mask = _inputs(seed, b, t)
    return _t(x), torch.from_numpy(mask), _port_composites(w)


def test_dropout_deterministic_and_unbiased():
    """Same generator state, same output; the mean over 24 seeds tracks
    the deterministic output (correlation > 0.99), as
    tests/test_pallas_attention.py:99-116 asks of the TPU kernel."""
    x, mask, comp = _dropout_case()
    run = lambda s: fused_composed_attention(
        x, mask, *comp, hd=HD, dropout=0.3,
        generator=torch.Generator().manual_seed(s))
    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.equal(run(5), run(6))
    mean = torch.stack([run(100 + i) for i in range(24)]).mean(0)
    ref = fused_composed_attention(x, mask, *comp, hd=HD)
    corr = np.corrcoef(mean.numpy().ravel(), ref.numpy().ravel())[0, 1]
    assert corr > 0.99, corr


def test_dropout_backward_regenerates_the_forward_mask():
    """The output is linear in vt for a fixed keep-mask, so f(vt + E) -
    f(vt) = <df/dvt, E> holds iff the backward used the forward's mask
    (tests/test_pallas_attention.py:156-181)."""
    x, mask, comp = _dropout_case(seed=4)
    wqk, wb, wvo, _ = comp
    qh = (torch.einsum("btc,hce->bhte", x, wqk) + wb[None, :, None, :])
    vt = torch.einsum("btc,hce->bhte", x, wvo)
    bias = torch.where(mask, 0.0, -1e30)
    seeds = torch.tensor([7, 11], dtype=torch.int32)
    r = np.random.default_rng(9)
    cot = _t(r.normal(size=x.shape))
    eps = _t(r.normal(size=vt.shape)) * 0.1

    def f(vt_):
        return (ComposedAttention.apply(qh, x, vt_, bias, seeds, SCALE, 0.3)
                * cot).sum()
    v = vt.clone().requires_grad_()
    f(v).backward()
    lhs = float(f(vt + eps) - f(vt))
    rhs = float((v.grad * eps).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-6) < 1e-3, (lhs, rhs)
    # and against another mask it fails
    other = ComposedAttention.apply(qh, x, vt + eps, bias, seeds + 1, SCALE,
                                    0.3)
    lhs_other = float((other * cot).sum() - f(vt))
    assert abs(lhs_other - rhs) / abs(rhs) > 1e-2


SCALE = 1.0 / math.sqrt(HD)


# ---- the float32 backward kernel's arithmetic: 3xTF32 ---------------------

def _tf32_bits(a, add):
    """float32 with ``add`` added to its encoding, then the low 13 bits
    cleared: TF32's 10 explicit mantissa bits."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + add) & 0xFFFFE000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def _split_tf32(a):
    """The kernels' split (composed_attn_common.cuh split_tf32): hi rounded
    to nearest by adding half a TF32 ulp to the encoding and masking, lo =
    a - hi as the tensor core reads it (truncated to TF32)."""
    hi = _tf32_bits(a, 0x1000)
    return hi, _tf32_bits(a - hi, 0)


def _emulated_plain(monkeypatch, passes, args,
                    fn=composed_attention_plain_bwd):
    """A plain version (the backward by default) with every product (the
    einsums) taken as the float32 kernels take it: three TF32 products,
    small terms first (a_lo b_hi + a_hi b_lo + a_hi b_hi), or one (a_hi
    b_hi)."""
    real = torch.einsum

    def tf32(eq, a, b):
        (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
        if passes == 1:
            return real(eq, ah, bh)
        return real(eq, al, bh) + real(eq, ah, bl) + real(eq, ah, bh)
    monkeypatch.setattr(torch, "einsum", tf32)
    try:
        return fn(*args)
    finally:
        monkeypatch.setattr(torch, "einsum", real)


def _grounding_width_case(t, seed):
    """Two rows at the kernels' width (8 heads, d = 128) with masked keys;
    the second row is fully masked."""
    g = torch.Generator().manual_seed(seed)
    qh = torch.randn(2, 8, t, 128, generator=g) * 0.1
    x = torch.randn(2, t, 128, generator=g)
    vt = torch.randn(2, 8, t, 128, generator=g) * 0.2
    do = torch.randn(2, t, 128, generator=g) * 0.5
    valid = torch.rand(2, t, generator=g) < 0.8
    valid[:, 0], valid[-1] = True, False
    bias = torch.where(valid, 0.0, -1e30)
    return qh, x, vt, bias, do


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """hi has TF32's 10 mantissa bits and lies within half a TF32 ulp of
    a; hi + lo_full = a exactly; the lo the tensor core reads is within
    2^-21 |a| of a - hi."""
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 10.0
    hi, lo = _split_tf32(a)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi.view(torch.int32)))
    assert ((a - hi).abs() <= 2.0 ** -11 * a.abs()).all()
    assert torch.equal(hi + (a - hi), a)
    assert ((lo - (a - hi)).abs() <= 2.0 ** -21 * a.abs()).all()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("t", [128, 512])
def test_plain_backward_in_3xtf32_holds_float32_tolerance(monkeypatch, t,
                                                          dropout):
    """The float32 backward kernels run every product as 3xTF32.  The plain
    backward with every product so emulated stays within the card's
    float32 tolerance (rtol 1e-4, atol 1e-5) of the plain float32 backward,
    masked keys and a fully masked row included."""
    qh, x, vt, bias, do = _grounding_width_case(t, seed=t)
    seeds = torch.tensor([5, -7], dtype=torch.int32)
    args = (qh, x, vt, bias, do, 0.25, dropout, seeds)
    want = composed_attention_plain_bwd(*args)
    got = _emulated_plain(monkeypatch, 3, args)
    for g3, w in zip(got, want):
        torch.testing.assert_close(g3, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [128, 512])
def test_one_tf32_pass_fails_float32_tolerance(monkeypatch, t):
    """One TF32 pass (a_hi b_hi) keeps about three digits: the plain
    backward so emulated leaves the float32 tolerance, which is why the
    kernels take three."""
    qh, x, vt, bias, do = _grounding_width_case(t, seed=t)
    seeds = torch.tensor([5, -7], dtype=torch.int32)
    args = (qh, x, vt, bias, do, 0.25, 0.1, seeds)
    want = composed_attention_plain_bwd(*args)
    one_pass = _emulated_plain(monkeypatch, 1, args)
    assert any(((g1 - w).abs() > 1e-5 + 1e-4 * w.abs()).any()
               for g1, w in zip(one_pass, want))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("t", [128, 512])
def test_plain_forward_in_3xtf32_holds_float32_tolerance(monkeypatch, t,
                                                         dropout):
    """The float32 forward kernels run both products (S = qh x^T and the
    weights times vt) as 3xTF32.  The plain forward with every product so
    emulated stays within the card's float32 tolerance (rtol 1e-4, atol
    1e-5) of the plain float32 forward, masked keys and a fully masked row
    included."""
    qh, x, vt, bias, _ = _grounding_width_case(t, seed=t + 1)
    seeds = torch.tensor([3, -11], dtype=torch.int32)
    args = (qh, x, vt, bias, 0.25, dropout, seeds)
    want = composed_attention_plain(*args)
    got = _emulated_plain(monkeypatch, 3, args, composed_attention_plain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [128, 512])
def test_one_tf32_pass_fails_forward_float32_tolerance(monkeypatch, t):
    """With one TF32 pass per product the plain forward leaves the float32
    tolerance, which is why the forward kernels take three."""
    qh, x, vt, bias, _ = _grounding_width_case(t, seed=t + 1)
    args = (qh, x, vt, bias, 0.25)
    want = composed_attention_plain(*args)
    one_pass = _emulated_plain(monkeypatch, 1, args, composed_attention_plain)
    assert ((one_pass - want).abs() > 1e-5 + 1e-4 * want.abs()).any()


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
@pytest.mark.parametrize("r,t", [(1, 128), (4, 128), (3, 192), (3, 512),
                                 (2, 1024)])
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
    with pytest.raises(ValueError, match="seeds"):
        composed_attention(qh, x, vt, bias, 0.25, dropout=0.1)


def _card_seeds(r, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (r,), dtype=torch.int32,
                         generator=g).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r,t", [(4, 128), (3, 192), (3, 512), (2, 1024)])
def test_cuda_dropout_forward_matches_plain(cuda_device, dtype, r, t):
    """The train instance at dropout 0.1 against the plain version on the
    same seeds (the masks agree bit for bit, so the outputs agree to the
    forward's tolerances); at dropout 0 it equals the inference
    instance."""
    qh, x, vt, bias = _card_inputs(r, t, dtype, cuda_device)
    seeds = _card_seeds(r, cuda_device)
    before = composed_attention_train.launches
    out = composed_attention(qh, x, vt, bias, 0.25, dropout=0.1, seeds=seeds)
    torch.cuda.synchronize()
    assert composed_attention_train.launches == before + 1
    want = composed_attention_plain(qh, x, vt, bias, 0.25, 0.1, seeds)
    torch.testing.assert_close(out, want, **CARD_TOLS[dtype])
    out0, stats = composed_attention_train(qh, x, vt, bias, 0.25, 0.0, seeds)
    torch.testing.assert_close(out0, composed_attention(qh, x, vt, bias,
                                                        0.25), rtol=0, atol=0)
    assert stats.shape == (r, 8, t, 2) and torch.isfinite(stats).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [None, 0.0, 0.1])
def test_cuda_forward_is_deterministic(cuda_device, dtype, dropout):
    """Two calls of a forward instance (inference: dropout None; train at
    dropout 0 and 0.1) on the same inputs give the same bits, statistics
    included."""
    qh, x, vt, bias = _card_inputs(3, 512, dtype, cuda_device, seed=6)
    seeds = _card_seeds(3, cuda_device, seed=6)
    if dropout is None:
        calls = [(composed_attention(qh, x, vt, bias, 0.25),)
                 for _ in range(2)]
    else:
        calls = [composed_attention_train(qh, x, vt, bias, 0.25, dropout,
                                          seeds) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*calls):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [None, 0.1])
def test_cuda_forward_fully_masked_row(cuda_device, dtype, dropout):
    """A row with no valid key gets the plain version's uniform softmax
    (the mean of vt over T, dropped at the same keys), from both
    instances."""
    qh, x, vt, bias = _card_inputs(2, 256, dtype, cuda_device, seed=8)
    assert (bias[1] < 0).all()
    seeds = _card_seeds(2, cuda_device, seed=8)
    p = dropout or 0.0
    if dropout is None:
        out = composed_attention(qh, x, vt, bias, 0.25)
    else:
        out = composed_attention_train(qh, x, vt, bias, 0.25, p, seeds)[0]
    want = composed_attention_plain(qh, x, vt, bias, 0.25, p, seeds)
    assert torch.isfinite(out).all() and out[1].abs().max() > 0
    torch.testing.assert_close(out[1], want[1], **CARD_TOLS[dtype])


@pytest.mark.gpu
def test_cuda_forward_runs_on_the_tensor_cores(cuda_device):
    """The built forward library: its two bf16 instances issue wgmma
    (HGMMA) and its two f32 instances TF32 mma (HMMA ... TF32)."""
    from vidsgg_big_tpu_torch.ops import build
    build.build(["composed_attn"])
    code = build.sass(build.library_path("composed_attn"))
    for key in ("bf16_kernelILb0E", "bf16_kernelILb1E", "f32_kernelILb0E",
                "f32_kernelILb1E"):
        (body,) = [v for k, v in code.items() if key in k]
        op = "HGMMA" if "bf16" in key else "HMMA"
        hits = [i for i in body if i.startswith(op) and
                ("TF32" in i or op == "HGMMA")]
        assert hits, key


# kernel vs plain backward: float32 sums in another order; in bf16 both
# round a_d and ds to bf16 before their products, after float32 sums taken
# in another order (one bf16 step, 2^-8 relative, at most)
CARD_GRAD_TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-5),
                  torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("r,t", [(4, 128), (2, 192), (3, 512), (64, 1024)])
def test_cuda_backward_matches_plain(cuda_device, dtype, dropout, r, t):
    """The backward kernels (bf16 on wgmma, f32 in 3xTF32) against the
    plain backward, and deterministic: a second call gives the same
    bits."""
    qh, x, vt, bias = _card_inputs(r, t, dtype, cuda_device)
    seeds = _card_seeds(r, cuda_device, seed=1)
    do = (torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
          * 0.5).to(cuda_device, dtype)
    _, stats = composed_attention_train(qh, x, vt, bias, 0.25, dropout,
                                        seeds)
    before = composed_attention_backward.launches
    got = composed_attention_backward(qh, x, vt, bias, seeds, stats, do,
                                      0.25, dropout)
    again = composed_attention_backward(qh, x, vt, bias, seeds, stats, do,
                                        0.25, dropout)
    torch.cuda.synchronize()
    assert composed_attention_backward.launches == before + 2
    want = composed_attention_plain_bwd(qh, x, vt, bias, do, 0.25, dropout,
                                        seeds)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, **CARD_GRAD_TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_backward_fully_masked_row(cuda_device, dtype):
    """A row with no valid key (every logit -1e30): the forward's uniform
    softmax is recomputed from (max, 1/l), so that row's gradients match
    the plain backward too."""
    qh, x, vt, bias = _card_inputs(2, 256, dtype, cuda_device, seed=5)
    assert (bias[1] < 0).all()
    seeds = _card_seeds(2, cuda_device, seed=3)
    do = (torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
          * 0.5).to(cuda_device, dtype)
    _, stats = composed_attention_train(qh, x, vt, bias, 0.25, 0.1, seeds)
    got = composed_attention_backward(qh, x, vt, bias, seeds, stats, do,
                                      0.25, 0.1)
    want = composed_attention_plain_bwd(qh, x, vt, bias, do, 0.25, 0.1,
                                        seeds)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g[1].abs().max() > 0
        torch.testing.assert_close(g[1], w[1], **CARD_GRAD_TOLS[dtype])


@pytest.mark.gpu
def test_cuda_backward_runs_on_the_tensor_cores(cuda_device):
    """The built backward library: its bf16 kernels issue wgmma (HGMMA)
    and its f32 kernels TF32 mma (HMMA ... TF32)."""
    from vidsgg_big_tpu_torch.ops import build
    build.build(["composed_attn_bwd"])
    code = build.sass(build.library_path("composed_attn_bwd"))
    for key in ("dq_bf16", "dkv_bf16", "dq_f32", "dkv_f32"):
        (body,) = [v for k, v in code.items() if key in k]
        op = "HGMMA" if "bf16" in key else "HMMA"
        hits = [i for i in body if i.startswith(op) and
                ("TF32" in i or op == "HGMMA")]
        assert hits, key
