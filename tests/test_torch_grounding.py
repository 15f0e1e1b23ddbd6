"""The port's grounding model against the JAX package on the CPU.

Weights are made by the JAX model's init, carried into the port with
``grounding_state_dict_from_jax``, and both models see the same numpy
inputs.  At ``dim_hidden=128``, T=128 and a 1 MiB attention budget the
combined encoder takes the composed path in both packages (JAX: its Pallas
kernel in interpret mode; the port: the plain composed version); at the demo
config's widths the attention is direct, or chunked under a small budget.
"""
import os

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.models import grounding as jax_grounding
from vidsgg_big_tpu.models.transplant import grounding_params_from_torch
from vidsgg_big_tpu.train.grounding_steps import (
    build_grounding_infer_step as jax_infer_step)
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.models import grounding
from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                   GroundingModel,
                                                   attention_lowering,
                                                   composed_encoders)
from vidsgg_big_tpu_torch.models.transplant import (
    grounding_state_dict_from_jax)
from vidsgg_big_tpu_torch.train.grounding_steps import (
    build_grounding_infer_step)

DEMO = parse_config_py(os.path.join(
    os.path.dirname(__file__), "..", "experiments", "demo",
    "config_grounding_.py"))["model_config"]
# the composed-path geometry: 128-wide, T = 128, B * Q = 8 rows
WIDE = dict(DEMO, dim_feat=64, dim_hidden=128, attn_bytes_budget=1 << 20)
B, Q, T = 2, 4, 128


def _inputs(cfg_dict, b=B, q=Q, t=T, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, cfg_dict["dim_feat"])).astype(np.float32)
    n_clips = np.array([t, t - 37][:b], np.int32)
    clip_mask = np.arange(t)[None] < n_clips[:, None]
    feats *= clip_mask[..., None]
    cats = np.stack([rng.integers(1, 81, (b, q)), rng.integers(1, 51, (b, q)),
                     rng.integers(1, 81, (b, q))], axis=-1).astype(np.int32)
    s = rng.uniform(0, 0.6, (b, q))
    temporal = np.stack([s, s + rng.uniform(0.1, 0.4, (b, q))],
                        -1).astype(np.float32)
    query_mask = np.ones((b, q), bool)
    query_mask[-1, -1] = False
    return feats, clip_mask, n_clips, cats, temporal, query_mask


def _models(cfg_dict, compute_dtype="float32"):
    cfg_dict = dict(cfg_dict, compute_dtype=compute_dtype,
                    fused_interpret=True)
    jmodel = jax_grounding.GroundingModel(
        jax_grounding.GroundingConfig.from_dict(cfg_dict))
    f, cm, _, qc, tp, qm = _inputs(cfg_dict, t=32)
    params = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(0), f, cm, qc, tp, qm))
    # the heads' final kernels x 0.02, as the JAX config's stable_head_init:
    # at the reference init the head logits saturate near +-200, where
    # float32 noise alone is 1e-3
    for head in ("regr_head", "conf_head", "cls_head"):
        params["params"][head]["out"]["point_wise"]["kernel"] *= 0.02
    model = GroundingModel(GroundingConfig.from_dict(cfg_dict))
    model.load_state_dict(grounding_state_dict_from_jax(params), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def wide_models():
    return _models(WIDE)


def _forward_both(models, inputs):
    jmodel, params, model = models
    feats, clip_mask, _, cats, temporal, query_mask = inputs
    jout = jmodel.apply(params, feats, clip_mask, cats, temporal, query_mask)
    with torch.no_grad():
        tout = model(*(torch.from_numpy(a) for a in (
            feats, clip_mask, cats, temporal, query_mask)))
    return [np.asarray(a, np.float32) for a in jout], \
        [a.float().numpy() for a in tout]


def _assert_close(jout, tout, rtol, atol):
    for name, j, t in zip(("regrs", "conf", "cls"), jout, tout):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)


def test_gate_takes_the_composed_path_here():
    """The geometry of these tests engages the composed path in the
    combined encoder only (JAX's gate, models/grounding.py:299-331)."""
    budget = WIDE["attn_bytes_budget"]
    assert attention_lowering(B * Q, T, 128, budget) == ("composed", 2)
    assert attention_lowering(B, T, 128, budget)[0] == "direct"
    assert attention_lowering(B * Q, 3, 128, budget)[0] == "direct"
    assert attention_lowering(B * Q, T, 128, budget,
                              composed=False) == ("chunked", 2)
    assert attention_lowering(B * Q, T, 32, budget) == ("chunked", 2)
    assert attention_lowering(3, T, 128, budget)[0] == "direct"   # odd b
    # bench geometry (B=4, Q=256, T=512, 1 GiB): the combined encoder only
    assert attention_lowering(1024, 512, 128, 1 << 30) == ("composed", 128)
    assert attention_lowering(4, 512, 128, 1 << 30)[0] == "direct"


def test_state_dict_round_trip(wide_models):
    """grounding_params_from_torch(grounding_state_dict_from_jax(p)) == p
    exactly, and the converted keys are the port model's own."""
    _, params, model = wide_models
    sd = grounding_state_dict_from_jax(params)
    assert set(sd) == set(model.state_dict())
    back = grounding_params_from_torch(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_forward_parity_composed_float32(wide_models, monkeypatch):
    """Composed path in the combined encoder (both packages), float32:
    within 1e-4 (sums in another order)."""
    calls = []
    real = grounding.fused_composed_attention
    monkeypatch.setattr(grounding, "fused_composed_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jout, tout = _forward_both(wide_models, _inputs(WIDE))
    assert composed_encoders(wide_models[2].cfg, B, Q, T) == [
        "combined_encoder"]
    assert len(calls) == 1
    _assert_close(jout, tout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused,flash", [(True, False), (False, True)],
                         ids=["fused", "flash"])
def test_layer_options_take_the_composed_path(wide_models, monkeypatch,
                                              fused, flash):
    """``fused_attention`` or the JAX package's stock-flash option
    (``flash_attention``, the same function) takes the composed path over
    budget; its output matches the chunked path the layer takes with
    neither (float32, 1e-4)."""
    calls = []
    real = grounding.fused_composed_attention
    monkeypatch.setattr(grounding, "fused_composed_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    layer = grounding.QANetEncoderLayer(
        128, 4, 7, attn_bytes_budget=WIDE["attn_bytes_budget"],
        fused_attention=fused, flash_attention=flash).eval()
    layer.load_state_dict(wide_models[2].combined_encoder.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B * Q, T, 128)).astype(np.float32))
    mask = torch.arange(T)[None] < torch.tensor([T, T - 37] * (B * Q // 2))[
        :, None]
    with torch.no_grad():
        out = layer(x, mask)
        assert len(calls) == 1
        layer.composed = False
        want = layer(x, mask)
    assert len(calls) == 1
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


def test_forward_parity_composed_bfloat16():
    """bfloat16 compute: every matmul and conv output is rounded to bf16
    (8 significant bits) in both packages but at different places (XLA
    fuses, PyTorch rounds each op), over 3 QANet blocks and 3 conv heads:
    logits within 0.25 + 5% and regression sigmoids within 0.05."""
    jout, tout = _forward_both(_models(WIDE, "bfloat16"), _inputs(WIDE))
    np.testing.assert_allclose(tout[0], jout[0], atol=5e-2)
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_allclose(t, j, rtol=5e-2, atol=0.25)


@pytest.mark.parametrize("budget", [1 << 30, 1 << 14],
                         ids=["direct", "chunked"])
def test_forward_parity_demo_dims(budget):
    """The demo config (dim_hidden 32, not 128-aligned): the direct path,
    and the chunked path under a budget that splits the rows."""
    cfg = dict(DEMO, attn_bytes_budget=budget)
    assert attention_lowering(B * Q, 64, 32, budget)[0] == (
        "direct" if budget == 1 << 30 else "chunked")
    jout, tout = _forward_both(_models(cfg), _inputs(cfg, t=64))
    _assert_close(jout, tout, rtol=1e-4, atol=1e-4)


def _decode_inputs(seed=3, b=2, q=5, t=17, k=4):
    rng = np.random.default_rng(seed)
    regrs = rng.uniform(0.0, 0.4, (b, q, t, 2, k)).astype(np.float32)
    conf = rng.normal(0, 2, (b, q, t, k)).astype(np.float32)
    cls = rng.normal(0, 2, (b, q, t, k)).astype(np.float32)
    n_clips = np.array([t, t - 6], np.int32)
    clip_mask = np.arange(t)[None] < n_clips[:, None]
    s = rng.uniform(0, 0.5, (b, q))
    inter = np.stack([s, s + rng.uniform(0.05, 0.5, (b, q))],
                     -1).astype(np.float32)
    qm = np.ones((b, q), bool)
    qm[1, -1] = False
    conf[0, 0] = -8.0                    # a query whose bins are all weak
    return regrs, conf, cls, inter, n_clips, clip_mask, qm


def test_temporal_pooling_and_nms_match_jax():
    regrs, conf, cls, inter, n_clips, clip_mask, _ = _decode_inputs()
    scores = (1 / (1 + np.exp(-conf))) * (1 / (1 + np.exp(-cls)))
    want = jax.vmap(lambda r, s, n, m: jax_grounding.temporal_pooling(
        r, s, n, m, 0.5, 0.5))(regrs, scores, n_clips, clip_mask)
    got = grounding.temporal_pooling(*(torch.from_numpy(a) for a in (
        regrs, scores, n_clips, clip_mask)), 0.5, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    rng = np.random.default_rng(4)
    s = rng.uniform(0, 0.7, (2, 5, 6, 1))
    spans = np.concatenate([s, s + rng.uniform(0.05, 0.3, (2, 5, 6, 1))],
                           -1).astype(np.float32)
    probs = rng.uniform(size=(2, 5, 6)).astype(np.float32)
    want = jax.vmap(lambda a, p: jax_grounding.temporal_nms(a, p, 0.5))(
        spans, probs)
    got = grounding.temporal_nms(torch.from_numpy(spans),
                                 torch.from_numpy(probs), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grounding_decode_matches_jax():
    """Masks exactly equal, spans and probabilities within 1e-6."""
    regrs, conf, cls, inter, n_clips, clip_mask, qm = _decode_inputs()
    kw = dict(score_th=0.5, tiou_th=0.5, bins_th=0.2, nms_th=0.5)
    want = jax.vmap(lambda *a: jax_grounding.grounding_decode(*a, **kw))(
        regrs, conf, cls, inter, n_clips, clip_mask, qm)
    got = grounding.grounding_decode(*(torch.from_numpy(a) for a in (
        regrs, conf, cls, inter, n_clips, clip_mask, qm)), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert got[1][0, 0, -1] == 0.0       # weak bins zero the fallback bin


def test_infer_step_matches_jax(wide_models):
    """build_grounding_infer_step on a padded batch (a short video, a
    masked query slot): masks exactly equal, spans within 1e-5."""
    jmodel, params, model = wide_models
    feats, clip_mask, n_clips, cats, temporal, qm = _inputs(WIDE, seed=5)
    kw = dict(score_th=0.9, tiou_th=0.5, bins_th=0.2, nms_th=0.8)
    want = jax.device_get(jax_infer_step(jmodel, **kw)(
        params, feats, clip_mask, n_clips, cats, temporal, qm))
    got = build_grounding_infer_step(model, **kw)(*(
        torch.from_numpy(a) for a in (feats, clip_mask, n_clips, cats,
                                      temporal, qm)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2].numpy()[-1, -1].any()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_stable_head_init_scales_the_final_head_kernels():
    """``stable_head_init`` (the JAX config's opt-in, kept by ``from_dict``)
    starts the three heads' final point-wise kernels at 0.02x the default
    init from the same generator; every other parameter is untouched."""
    cfg = GroundingConfig.from_dict(dict(DEMO, stable_head_init=True))
    assert cfg.stable_head_init
    assert not GroundingConfig.from_dict(DEMO).stable_head_init
    plain = GroundingModel(GroundingConfig.from_dict(DEMO),
                           generator=torch.Generator().manual_seed(0))
    stable = GroundingModel(cfg, generator=torch.Generator().manual_seed(0))
    finals = {f"{h}.4.point_wise.weight"
              for h in ("regr_head", "conf_head", "cls_head")}
    want = plain.state_dict()
    for name, got in stable.state_dict().items():
        if name in finals:
            torch.testing.assert_close(got, want[name] * 0.02, rtol=0,
                                       atol=0)
            assert got.abs().max() > 0
        else:
            assert torch.equal(got, want[name]), name
    assert finals <= set(want)
