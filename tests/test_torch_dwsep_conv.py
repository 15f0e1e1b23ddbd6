"""The grounding model's depthwise-separable conv: the plain version against
the model's ATen route, the registered op's CPU dispatch, the gradient
route, the kernel's 3xTF32 pointwise product emulated on the grounding
forward, and, on a card, the CUDA kernel against the plain version.

The host with the card has no JAX; nothing here imports it, and the card's
tests run without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_dwsep_conv.py
"""
import pytest
import torch
import torch.nn.functional as F

from test_torch_composed_attn import _split_tf32
from vidsgg_big_tpu_torch.models import grounding
from vidsgg_big_tpu_torch.models.grounding import (DepthwiseSeparableConv,
                                                   GroundingConfig,
                                                   GroundingModel)
from vidsgg_big_tpu_torch.ops.dwsep_conv import (conv_epilogue, dwsep_conv,
                                                 dwsep_conv_op,
                                                 dwsep_conv_plain)

C = 128


def _parent_route(conv, x, relu, residual, mask):
    """The model's float32 route before the kernel, written out: the conv
    module on the transposed input, then its callers' ReLU, residual and
    mask passes (``QANetEncoderLayer``: ``z(F.relu(conv(out)) + res)``;
    ``ConvHead``: ``z(block(x))``)."""
    xc = x.transpose(1, 2)
    dw, pw = conv.depth_wise, conv.point_wise
    pad = conv.kernel_size // 2
    y = F.conv1d(xc, dw.weight, dw.bias, padding=pad, groups=xc.shape[1])
    y = F.conv1d(y, pw.weight, pw.bias).transpose(1, 2)
    if relu:
        y = F.relu(y)
    if residual is not None:
        y = y + residual
    if mask is not None:
        y = y.masked_fill(~mask[..., None], 0.0)
    return y


def _case(r, t, co, k, residual, masked, seed=0, device="cpu"):
    """A conv module with nonzero biases and its inputs: x (r, t, 128), a
    residual (r, t, co) or None, a mask with a partly and a fully masked
    row or None."""
    g = torch.Generator().manual_seed(seed)
    conv = DepthwiseSeparableConv(C, co, k)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x = torch.randn(r, t, C, generator=g)
    res = torch.randn(r, t, co, generator=g) if residual else None
    mask = None
    if masked:
        mask = torch.rand(r, t, generator=g) < 0.7
        mask[0, : t // 2] = False
        mask[-1] = False
    conv = conv.to(device)
    return conv, [None if a is None else a.to(device) for a in (x, res,
                                                                mask)]


def _weights(conv):
    return (conv.depth_wise.weight, conv.depth_wise.bias,
            conv.point_wise.weight, conv.point_wise.bias)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("relu,residual", [(False, False), (True, False),
                                           (True, True), (False, True)],
                         ids=["none", "relu", "relu_res", "res"])
@pytest.mark.parametrize("t", [3, 7, 129])
@pytest.mark.parametrize("co", [128, 20, 10])
@pytest.mark.parametrize("k", [3, 7])
def test_plain_matches_the_parent_route(k, co, t, relu, residual, masked):
    """dwsep_conv_plain equals the model's float32 route before the kernel
    bit for bit, contiguous."""
    conv, (x, res, mask) = _case(3, t, co, k, residual, masked, seed=t + k)
    with torch.no_grad():
        got = dwsep_conv_plain(x, *_weights(conv), relu, res, mask)
        want = _parent_route(conv, x, relu, res, mask)
    assert got.is_contiguous() and got.shape == (3, t, co)
    assert torch.equal(got, want)
    if mask is not None:
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))


def test_cpu_op_dispatches_to_the_plain_version():
    """On the CPU the registered op is the plain version and counts no
    launch; its schema and fake pass opcheck, with and without the
    optional residual and mask."""
    conv, (x, res, mask) = _case(2, 9, C, 7, True, True)
    w = [a.detach() for a in _weights(conv)]
    before = dwsep_conv.launches
    got = dwsep_conv(x, *w, True, res, mask)
    assert torch.equal(got, dwsep_conv_plain(x, *w, True, res, mask))
    assert dwsep_conv.launches == before
    torch.library.opcheck(dwsep_conv_op, (x, *w, True, res, mask))
    torch.library.opcheck(dwsep_conv_op, (x, *w, False, None, None))


def test_model_routes_by_dtype_width_and_gradient(monkeypatch):
    """A float32 call without a gradient to record, at C = 128, takes the
    op; a gradient-recording call, bfloat16 and another width keep the ATen
    route, and the gradient-recording call's output and gradients equal
    the parent route's bit for bit."""
    calls = []
    real = grounding.dwsep_conv
    monkeypatch.setattr(grounding, "dwsep_conv",
                        lambda *a: calls.append(1) or real(*a))
    conv, (x, res, mask) = _case(2, 33, C, 7, True, True, seed=5)
    with torch.no_grad():
        conv(x, relu=True, residual=res, mask=mask)
    assert len(calls) == 1
    with torch.inference_mode():
        conv(x, relu=True, residual=res, mask=mask)
    assert len(calls) == 2

    got_x = x.clone().requires_grad_()
    out = conv(got_x, relu=True, residual=res, mask=mask)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out * cot).sum().backward()
    got = [got_x.grad] + [p.grad.clone() for p in conv.parameters()]
    assert len(calls) == 2
    conv.zero_grad()
    want_x = x.clone().requires_grad_()
    ref = _parent_route(conv, want_x, True, res, mask)
    (ref * cot).sum().backward()
    want = [want_x.grad] + [p.grad for p in conv.parameters()]
    assert torch.equal(out, ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    with torch.no_grad():
        conv.to(torch.bfloat16)(x.to(torch.bfloat16), relu=True)
        DepthwiseSeparableConv(64, 64, 3)(x[..., :64])
    assert len(calls) == 2


# ---- the kernel's pointwise product, 3xTF32, on the grounding forward -----

# the composed-path geometry of tests/test_torch_grounding.py: 128 wide,
# T = 128, B * Q = 8 rows
B, Q, T = 2, 4, 128


def _emulated_conv(passes):
    """dwsep_conv with its pointwise product taken as the kernel takes it:
    the depthwise sums and the pointwise weights split into TF32 hi and lo
    (the kernels' split, checked in test_torch_composed_attn.py), then
    three TF32 products, small terms first, or one (hi hi)."""
    def conv(x, dw, db, pw, pb, relu=False, residual=None, mask=None):
        d = F.conv1d(x.transpose(1, 2), dw, db, padding=dw.shape[-1] // 2,
                     groups=x.shape[-1]).transpose(1, 2)
        (ah, al), (bh, bl) = _split_tf32(d), _split_tf32(pw[:, :, 0])
        mm = lambda a, b: torch.einsum("rtc,oc->rto", a, b)
        y = mm(ah, bh) if passes == 1 else \
            mm(al, bh) + mm(ah, bl) + mm(ah, bh)
        return conv_epilogue(y + pb, relu, residual, mask).contiguous()
    return conv


@pytest.fixture(scope="module")
def wide_forward():
    """A grounding model at the composed-path geometry (the port's init,
    the JAX config's stable head init), its inputs and its float32
    outputs."""
    cfg = GroundingConfig(dim_feat=64, dim_hidden=128,
                          attn_bytes_budget=1 << 20, stable_head_init=True)
    model = GroundingModel(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(B, T, 64, generator=g)
    clip_mask = torch.arange(T)[None] < torch.tensor([[T], [T - 37]])
    feats = feats * clip_mask[..., None]
    cats = torch.stack([torch.randint(1, 81, (B, Q), generator=g),
                        torch.randint(1, 51, (B, Q), generator=g),
                        torch.randint(1, 81, (B, Q), generator=g)], -1)
    s = torch.rand(B, Q, generator=g) * 0.6
    temporal = torch.stack([s, s + 0.2], -1)
    inputs = (feats, clip_mask, cats, temporal)
    with torch.no_grad():
        want = model.eval()(*inputs)
    return model, inputs, want


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_grounding_forward_with_the_kernels_product(wide_forward,
                                                    monkeypatch, passes):
    """With every conv's pointwise product in 3xTF32 the grounding forward
    stays within test_forward_parity_composed_float32's tolerance (rtol
    1e-4, atol 1e-4) of the float32 forward; with one TF32 pass it leaves
    it, which is why the kernel takes three."""
    model, inputs, want = wide_forward
    calls = []
    emulated = _emulated_conv(passes)
    monkeypatch.setattr(grounding, "dwsep_conv",
                        lambda *a: calls.append(1) or emulated(*a))
    with torch.no_grad():
        got = model(*inputs)
    assert len(calls) == 27
    close = [torch.allclose(g, w, rtol=1e-4, atol=1e-4)
             for g, w in zip(got, want)]
    if passes == 3:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    else:
        assert not all(close)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from vidsgg_big_tpu_torch.utils.device import strict_float32
    strict_float32()
    return torch.device("cuda")


# kernel vs plain (cuDNN in full float32): 3xTF32 products summed in
# another order
CARD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("r,t,co,k,relu,residual,masked", [
    # the grounding-serving cell's shapes: QANet convs, head blocks, the
    # final head convs
    (1024, 512, 128, 7, True, True, True),
    (1024, 512, 128, 3, True, False, True),
    (1024, 512, 20, 3, False, False, False),
    (1024, 512, 10, 3, False, False, False),
    # the query encoder's T = 3, and row edges off the tiles' grid
    (1024, 3, 128, 3, True, True, False),
    (5, 7, 128, 7, True, True, True),
    (3, 129, 20, 7, False, True, True),
    (3, 129, 10, 3, True, False, True),
    (2, 7, 10, 7, False, False, False),
    (7, 129, 128, 3, False, False, False),
])
def test_cuda_kernel_matches_plain(cuda_device, r, t, co, k, relu, residual,
                                   masked):
    conv, (x, res, mask) = _case(r, t, co, k, residual, masked,
                                 seed=r + t + co + k, device=cuda_device)
    w = [a.detach() for a in _weights(conv)]
    before = dwsep_conv.launches
    out = dwsep_conv(x, *w, relu, res, mask)
    torch.cuda.synchronize()
    assert dwsep_conv.launches == before + 1
    want = dwsep_conv_plain(x, *w, relu, res, mask)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, **CARD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("k,residual", [(7, True), (3, False)])
def test_cuda_kernel_is_as_exact_as_float32(cuda_device, k, residual):
    """Against float64 at the serving cell's shapes, the kernel's largest
    error is no larger than cuDNN's float32 conv's, and its mean signed
    error stays under 2e-7: the tensor cores' sums, rounded toward zero,
    drift by -6.8e-7 when one accumulator takes all 48 products."""
    conv, (x, res, mask) = _case(1024, 512, C, k, residual, True,
                                 device=cuda_device)
    w = [a.detach() for a in _weights(conv)]
    want = dwsep_conv_plain(*(a.double() for a in (x, *w)), True,
                            None if res is None else res.double(), mask)
    kernel = dwsep_conv(x, *w, True, res, mask).double() - want
    cudnn = dwsep_conv_plain(x, *w, True, res, mask).double() - want
    assert kernel.abs().max() <= cudnn.abs().max()
    assert kernel.mean().abs() < 2e-7


@pytest.mark.gpu
def test_cuda_fully_masked_rows_are_zero_and_launches_repeat(cuda_device):
    """Masked positions read exact zeros; two launches give the same
    bits."""
    conv, (x, res, mask) = _case(64, 512, C, 7, True, True,
                                 device=cuda_device)
    w = [a.detach() for a in _weights(conv)]
    out = dwsep_conv(x, *w, True, res, mask)
    again = dwsep_conv(x, *w, True, res, mask)
    assert torch.equal(out, again)
    assert torch.equal(out[~mask], torch.zeros_like(out[~mask]))
    assert out[mask].abs().max() > 0


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    conv, (x, res, mask) = _case(2, 16, C, 3, True, True, device=cuda_device)
    w = [a.detach() for a in _weights(conv)]
    with pytest.raises(ValueError):              # another width
        dwsep_conv(x[..., :64].contiguous(),
                   *[a.detach() for a in _weights(
                       DepthwiseSeparableConv(64, 64, 3).cuda())])
    with pytest.raises(ValueError):              # an even kernel
        even = DepthwiseSeparableConv(C, C, 4).cuda()
        dwsep_conv(x, *[a.detach() for a in _weights(even)])
    with pytest.raises(ValueError):              # a wider one than 7
        wide = DepthwiseSeparableConv(C, C, 9).cuda()
        dwsep_conv(x, *[a.detach() for a in _weights(wide)])
    with pytest.raises(ValueError):              # not contiguous
        dwsep_conv(x.transpose(0, 1), *w)
    with pytest.raises(ValueError):              # residual of another shape
        dwsep_conv(x, *w, True, res[:, :8].contiguous(), mask)
    with pytest.raises(TypeError):               # not float32
        dwsep_conv(x.double(), *w)
    with pytest.raises(TypeError):               # a mask not bool
        dwsep_conv(x, *w, True, res, mask.to(torch.uint8))
    with pytest.raises(ValueError):              # another device
        dwsep_conv(x, w[0].cpu(), *w[1:])


@pytest.mark.gpu
def test_cuda_kernel_runs_on_the_tensor_cores(cuda_device):
    """Every instance of the built library issues TF32 mma (HMMA ...
    TF32)."""
    from vidsgg_big_tpu_torch.ops import build
    build.build(["dwsep_conv"])
    code = build.sass(build.library_path("dwsep_conv"))
    kernels = {k: v for k, v in code.items() if "dwsep_conv_kernel" in k}
    assert len(kernels) == 12
    for name, body in kernels.items():
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in body]                   # past the predicate
        assert any(o.startswith("HMMA") and "TF32" in o for o in ops), name


@pytest.mark.gpu
def test_cuda_grounding_launches(cuda_device):
    """One grounding inference forward launches the kernel 27 times and
    matches the CPU's; a train-mode forward and backward launches it
    never."""
    cfg = GroundingConfig(dim_feat=64, dim_hidden=128,
                          attn_bytes_budget=1 << 20, stable_head_init=True)
    model = GroundingModel(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    clip_mask = torch.arange(T)[None] < torch.tensor([[T], [T - 37]])
    inputs = (torch.randn(B, T, 64, generator=g) * clip_mask[..., None],
              clip_mask, torch.randint(1, 51, (B, Q, 3), generator=g),
              torch.rand(B, Q, 2, generator=g).sort(-1).values)
    with torch.no_grad():
        want = model.eval()(*inputs)
    model = model.to(cuda_device)
    dev = [a.to(cuda_device) for a in inputs]
    before = dwsep_conv.launches
    with torch.inference_mode():
        got = model(*dev)
    assert dwsep_conv.launches == before + 27
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    model.train()
    out = model(*dev, generator=torch.Generator().manual_seed(3))
    sum(o.sum() for o in out).backward()
    assert dwsep_conv.launches == before + 27
