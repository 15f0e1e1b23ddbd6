"""int8 feature storage in the PyTorch port against the JAX package (CPU).

``pack_proposal(dtype=np.int8)`` must give JAX's bytes and scale; the
port's int8 first layer (``models/layers.int8_linear``) JAX ``Int8Dense``'s
int32 accumulator exactly and its bfloat16 output; BIG-C v10 and v7 on
int8 batches JAX's int8 forward; and train mode must dequantize the int8
features once up front, as JAX's BigC does.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.data.types import (VideoProposalRecord,
                                       pack_proposal as jax_pack,
                                       stack_batches as jax_stack)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.models.layers import Int8Dense
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data.bucketing import BucketSpec, bucketed_batches
from vidsgg_big_tpu_torch.data.transfer import batch_to_device, wire_feats
from vidsgg_big_tpu_torch.data.types import pack_proposal, stack_batches
from vidsgg_big_tpu_torch.models import layers
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.models.transplant import bigc_state_dict_from_jax

DEMO = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo")
V10 = parse_config_py(os.path.join(DEMO, "config_smoke_.py"))["model_config"]
V7 = parse_config_py(os.path.join(DEMO, "config_vidor_.py"))["model_config"]
N_BUCKET, T_BUCKET = 16, 64


def _records(seeds, feat):
    return [make_video(s, video_len=60, n_gt_trajs=6, n_preds=8,
                       n_distractors=6, feat_dim=feat)[0] for s in seeds]


def _empty(feat):
    return VideoProposalRecord(
        video_name="e", video_len=40, video_wh=(64, 48),
        cat_ids=np.zeros((0,), np.int32), scores=np.zeros((0,), np.float32),
        durations=np.zeros((0, 2), np.int32), boxes=[], features=[])


@pytest.mark.parametrize("case", ["record", "empty", "wide"])
def test_pack_proposal_int8_is_bit_equal_to_jax(case):
    """The int8 bytes and the per-video scale equal JAX's, the empty
    record included (scale 1e-12, all zeros, no crash); float32 storage
    keeps a scale of 1."""
    feat = 80 if case != "wide" else 2048 + 832
    rec = _empty(feat) if case == "empty" else _records([3], feat)[0]
    if case == "wide":
        rec.features = [f * 7.5 for f in rec.features]
    j = jax_pack(rec, N_BUCKET, T_BUCKET, feat, dtype=np.int8)
    t = pack_proposal(rec, N_BUCKET, T_BUCKET, feat, dtype=np.int8)
    assert t.feats.dtype == np.int8 and t.feat_scale.dtype == np.float32
    assert t.feats.tobytes() == np.asarray(j.feats).tobytes()
    assert t.feat_scale.tobytes() == np.asarray(
        j.feat_scale, np.float32).tobytes()
    for name in ("boxes", "stretch_idx", "durations", "traj_mask"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    assert float(pack_proposal(rec, N_BUCKET, T_BUCKET, feat).feat_scale) \
        == 1.0


def test_int8_stacks_buckets_and_travels_as_packed():
    """BucketSpec(feat_dtype="int8") packs int8 with a (B,) scale; the
    wire keeps the bytes; a float wire for int8 features (or the reverse)
    raises; ``.to(feats=bf16)`` leaves int8 features alone."""
    recs = [(r, None) for r in _records([1, 2, 3], 80)]
    spec = BucketSpec(feat_dim=80, feat_dtype="int8")
    _, _, props, _ = next(iter(bucketed_batches(recs, spec, 3,
                                                with_gt=False)))
    assert props.feats.dtype == np.int8 and props.feat_scale.shape == (3,)
    np.testing.assert_array_equal(props.feat_scale, np.stack([
        jax_pack(r, *props.feats.shape[1:3], 80, dtype=np.int8).feat_scale
        for r, _ in recs]))
    assert torch.equal(wire_feats(props.feats, torch.int8),
                       torch.from_numpy(props.feats))
    with pytest.raises(ValueError, match="int8"):
        wire_feats(props.feats, torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        wire_feats(np.zeros((2, 3), np.float32), torch.int8)
    dev = props.to("cpu", feats=torch.bfloat16)
    assert dev.feats.dtype == torch.int8
    assert dev.feat_scale.dtype == torch.float32


@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (40, 24)])
def test_int8_linear_matches_jax_int8dense(shape):
    """The int32 accumulator exactly equal to JAX's; the bfloat16 output
    within 1e-2 relative (one bf16 rounding of the same float32 value)."""
    rng = np.random.default_rng(0)
    k, n = shape[-1], 48
    x = rng.integers(-127, 128, shape).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, shape[:1] + (1,) * (len(shape) - 1)
                        ).astype(np.float32)
    dense = Int8Dense(n)
    params = dense.init(jax.random.PRNGKey(0), x, scale)
    kernel = np.asarray(params["params"]["kernel"])
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    params = {"params": {"kernel": kernel, "bias": bias}}
    jy = np.asarray(dense.apply(params, x, scale), np.float32)
    sw = jnp.max(jnp.abs(kernel), axis=0) / 127.0
    kq = jnp.round(kernel / sw).astype(jnp.int8)
    jacc = np.asarray(jnp.dot(x, kq, preferred_element_type=jnp.int32))

    lin = torch.nn.Linear(k, n)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    tsw, tkq = layers.quantize_weight(lin.weight)
    np.testing.assert_array_equal(tkq.numpy().T, np.asarray(kq))
    np.testing.assert_array_equal(tsw.detach().numpy(), np.asarray(sw))
    tacc = layers.int8_accumulate(torch.from_numpy(x), tkq)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    ty = layers.int8_linear(lin, torch.from_numpy(x),
                            torch.from_numpy(scale))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().detach().numpy(), jy, rtol=1e-2,
                               atol=1e-2 * np.abs(jy).max())


@pytest.mark.parametrize("mkn,ok", [((17, 64, 512), True),
                                    ((16, 64, 512), False),
                                    ((4096, 2052, 512), False),
                                    ((4096, 1024, 500), False)])
def test_int_mm_shape_rule_names_the_shape(mkn, ok):
    """The card's torch._int_mm rules (more than 16 rows, K and N
    multiples of 8) raise naming the product's shape; no float fallback."""
    if ok:
        layers.check_int_mm_shape(*mkn)
        return
    with pytest.raises(ValueError, match=rf"\({mkn[0]} x {mkn[1]}\)"):
        layers.check_int_mm_shape(*mkn)


def _models(mc, variant, compute_dtype="float32", **overrides):
    mc = dict(mc, compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(JaxBigCConfig.from_dict(mc, variant=variant),
                               **overrides)
    cfg = dataclasses.replace(BigCConfig.from_dict(mc, variant=variant),
                              **overrides)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(cfg.num_enti_cats, cfg.dim_clsme)).astype(
        np.float32)
    tables = {"enti_name_emb": emb}
    jmodel = JaxBigC(jcfg, enti_name_emb=emb if cfg.name_emb_in_head
                     else None)
    feat = _feat(cfg)
    jb = jax_stack([jax_pack(r, N_BUCKET, T_BUCKET, feat)
                    for r in _records([0], feat)])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jb))
    params["params"]["bias_matrix"] = rng.normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    model = BigC(cfg)
    model.load_state_dict(bigc_state_dict_from_jax(params, cfg, tables),
                          strict=True)
    return jmodel, params, model, cfg


def _feat(cfg):
    return cfg.dim_feat + (cfg.dim_i3d or 0) + (cfg.dim_clsme if
                                                cfg.variant == "v7" else 0)


def _int8_batches(seeds, feat):
    recs = _records(seeds, feat)
    jb = jax_stack([jax_pack(r, N_BUCKET, T_BUCKET, feat, dtype=np.int8)
                    for r in recs])
    tb = stack_batches([pack_proposal(r, N_BUCKET, T_BUCKET, feat,
                                      dtype=np.int8) for r in recs])
    return jb, tb.to("cpu")


@pytest.mark.parametrize("variant", ["v10", "v7"])
def test_bigc_int8_forward_matches_jax(variant):
    """BIG-C on an int8 batch (float32 compute): the int8 first layer
    returns bfloat16 in both packages, the rest runs float32.  att and
    pred_logits within 1e-4 of JAX's int8 forward (the float32 tail's
    tolerance), and the quantization moves the logits from the float32
    ones as it does in JAX: the cosine between int8 and float32 logits
    equal to JAX's within 1e-6.  (JAX's own closeness criterion, cosine >
    0.999, holds at its test's widths, not at these: 0.99 in both
    packages here.)"""
    mc = V10 if variant == "v10" else V7
    jmodel, params, model, cfg = _models(mc, variant)
    jb, tb = _int8_batches((1, 2), _feat(cfg))
    jout = jmodel.apply(params, jb)
    with torch.no_grad():
        tout = model.eval()(tb)
    for k in ("pred_logits", "att", "enti_feat"):
        np.testing.assert_allclose(tout[k].float().numpy(),
                                   np.asarray(jout[k], np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    recs = _records((1, 2), _feat(cfg))
    fb = stack_batches([pack_proposal(r, N_BUCKET, T_BUCKET, _feat(cfg))
                        for r in recs])
    with torch.no_grad():
        f32 = model(fb.to("cpu"))["pred_logits"].double().numpy()
    jf32 = np.asarray(jmodel.apply(params, jax_stack([
        jax_pack(r, N_BUCKET, T_BUCKET, _feat(cfg)) for r in recs]))[
        "pred_logits"], np.float64)

    def cosine(a, b):
        return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    port_cos = cosine(f32, tout["pred_logits"].double().numpy())
    jax_cos = cosine(jf32, np.asarray(jout["pred_logits"], np.float64))
    assert port_cos > 0.9 and abs(port_cos - jax_cos) < 1e-6, (port_cos,
                                                               jax_cos)


def test_bigc_train_mode_dequantizes_up_front():
    """Train mode (JAX :270-278): the int8 features are dequantized once,
    in the compute dtype, before the encoder, so the int8 batch trains as
    its dequantized float batch does (equal outputs and gradients), JAX's
    train-mode outputs agree within 1e-4 (dropout 0), and the first visual
    layer gets a gradient."""
    jmodel, params, model, cfg = _models(V10, "v10", dropout=0.0)
    jb, tb = _int8_batches((4, 5), _feat(cfg))
    deq = tb.replace(feats=tb.feats.float() * tb.feat_scale[:, None, None,
                                                             None])
    model.train()
    grads = []
    for batch in (tb, deq):
        model.zero_grad()
        out = model(batch)
        (out["pred_logits"] ** 2).mean().backward()
        grads.append((out["pred_logits"].detach(),
                      {k: p.grad.clone() for k, p in
                       model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for k, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][k]), k
    assert grads[0][1]["fc_feat2enti.0.weight"].abs().max() > 0
    jout = jmodel.apply(params, jb, deterministic=False)
    np.testing.assert_allclose(grads[0][0].numpy(),
                               np.asarray(jout["pred_logits"]), rtol=1e-4,
                               atol=1e-4)


def test_int8_train_wire_to_device():
    """batch_to_device with an int8 wire carries int8 features and their
    scale; a float32 wire leaves scale 1."""
    from vidsgg_big_tpu_torch.data.types import pack_gt
    vids = [make_video(s, video_len=60, feat_dim=80) for s in (1, 2)]
    props = stack_batches([pack_proposal(p, N_BUCKET, T_BUCKET, 80,
                                         dtype=np.int8) for p, _ in vids])
    gts = stack_batches([pack_gt(g, 8, 64, 16) for _, g in vids])
    p, _ = batch_to_device(props, gts, torch.device("cpu"), torch.int8)
    assert p.feats.dtype == torch.int8 and p.feat_scale.shape == (2,)
    assert (p.feat_scale < 1).all()
