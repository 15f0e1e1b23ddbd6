"""BIG-C v10 in the PyTorch port against the JAX package on the CPU.

Weights are made by the JAX model's init (plus a random frequency-bias
prior and name-embedding table), carried into the port with
``bigc_state_dict_from_jax``, and both models see the same numpy-packed
records at the demo config's widths (12 tracklets, T <= 64).
"""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.data.types import (pack_proposal as jax_pack,
                                       stack_batches as jax_stack)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.models.transplant import bigc_params_from_torch
from vidsgg_big_tpu.train.steps import build_infer_step as jax_infer_step
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data.types import pack_proposal, stack_batches
from vidsgg_big_tpu_torch.models import layers as torch_layers
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.models.transplant import bigc_state_dict_from_jax
from vidsgg_big_tpu_torch.train.steps import build_infer_step

MODEL_CONFIG = parse_config_py(os.path.join(
    os.path.dirname(__file__), "..", "experiments", "demo", "config_smoke_.py"))[
    "model_config"]
FEAT = MODEL_CONFIG["dim_feat"] + MODEL_CONFIG["dim_i3d"]
N_BUCKET, T_BUCKET = 16, 64


def _records(seeds, feat=FEAT):
    return [make_video(s, video_len=60, n_gt_trajs=6, n_preds=8,
                       n_distractors=6, feat_dim=feat)[0] for s in seeds]


def _batches(recs, feat_bf16=False):
    """The same records packed by both packages: (JAX batch, port batch)."""
    import ml_dtypes
    feat = recs[0].features[0].shape[1]
    jb = jax_stack([jax_pack(r, N_BUCKET, T_BUCKET, feat, dtype=(
        ml_dtypes.bfloat16 if feat_bf16 else np.float32)) for r in recs])
    tb = stack_batches([pack_proposal(r, N_BUCKET, T_BUCKET, feat)
                        for r in recs]).to(
        "cpu", feats=torch.bfloat16 if feat_bf16 else torch.float32)
    return jb, tb


def _models(compute_dtype="float32", **overrides):
    mc = dict(MODEL_CONFIG, compute_dtype=compute_dtype, **overrides)
    jcfg, cfg = JaxBigCConfig.from_dict(mc), BigCConfig.from_dict(mc)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(cfg.num_enti_cats, cfg.dim_clsme)).astype(
        np.float32)
    jmodel = JaxBigC(jcfg, enti_name_emb=emb)
    jb, _ = _batches(_records([0], cfg.dim_feat + (cfg.dim_i3d or 0)))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jb))
    params["params"]["bias_matrix"] = rng.normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    model = BigC(cfg)
    model.load_state_dict(bigc_state_dict_from_jax(
        params, cfg, {"enti_name_emb": emb}), strict=True)
    return jmodel, params, model.eval(), emb


@pytest.fixture(scope="module")
def f32_models():
    return _models()


def test_state_dict_round_trip(f32_models):
    """bigc_params_from_torch(bigc_state_dict_from_jax(p)) == p exactly, and
    the converted keys are the port model's own state_dict keys."""
    _, params, model, emb = f32_models
    cfg = model.cfg
    sd = bigc_state_dict_from_jax(params, cfg, {"enti_name_emb": emb})
    assert set(sd) == set(BigC(cfg).state_dict())
    back, tables = bigc_params_from_torch(sd, JaxBigCConfig.from_dict(
        MODEL_CONFIG))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    np.testing.assert_array_equal(tables["enti_name_emb"], emb)


def test_layer_norms_use_flax_epsilon(f32_models):
    norms = [m for m in f32_models[2].modules()
             if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * MODEL_CONFIG["n_enco_layers"] + \
        3 * MODEL_CONFIG["n_deco_layers"]
    assert all(m.eps == 1e-6 for m in norms)


def _forward_both(models, jb, tb):
    jmodel, params, model, _ = models
    jout = jmodel.apply(params, jb)
    with torch.no_grad():
        tout = model(tb)
    return ({k: np.asarray(v, np.float32) for k, v in jout.items()},
            {k: v.float().numpy() for k, v in tout.items()})


@pytest.mark.parametrize("seeds", [(1, 2), (3, 4, 5)])
def test_forward_parity_float32(f32_models, seeds):
    """pred_logits and att within 1e-4 in float32 (sums differ only in
    order between XLA and PyTorch)."""
    jout, tout = _forward_both(f32_models, *_batches(_records(seeds)))
    for k in ("pred_logits", "att", "enti_feat", "pred_queries"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_forward_parity_without_i3d():
    """exp1's head (PKU tracklets, no I3D): name embeddings and node
    features only, float32 tolerance as above."""
    models = _models(dim_i3d=None)
    assert not hasattr(models[2], "fc_i3d")
    jout, tout = _forward_both(models, *_batches(
        _records((1, 2), MODEL_CONFIG["dim_feat"])))
    for k in ("pred_logits", "att"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("feat_bf16", [False, True])
def test_forward_parity_bfloat16(feat_bf16):
    """compute_dtype bfloat16: logits within atol 5e-2 and att within 1e-2.
    bf16 keeps about 3 significant digits, and the two frameworks round
    at different places (XLA may fuse a matmul with its bias add, PyTorch
    rounds each op's output), so the float32 tolerance cannot hold."""
    models = _models("bfloat16")
    jout, tout = _forward_both(models, *_batches(_records((1, 2)),
                                                 feat_bf16=feat_bf16))
    np.testing.assert_allclose(tout["pred_logits"], jout["pred_logits"],
                               atol=5e-2)
    np.testing.assert_allclose(tout["att"], jout["att"], atol=1e-2)


def test_fully_masked_padded_video(f32_models):
    """A padded batch repeat (every tracklet masked, as the bucketer emits
    it) gives zero attention and finite logits, like JAX."""
    jb, tb = _batches(_records((1, 2)))
    jb = jb.replace(traj_mask=np.asarray(jb.traj_mask) & np.array(
        [[True], [False]]))
    tb = tb.replace(traj_mask=tb.traj_mask & torch.tensor([[True], [False]]))
    jout, tout = _forward_both(f32_models, jb, tb)
    assert np.isfinite(tout["pred_logits"]).all()
    assert not tout["att"][1].any()
    for k in ("pred_logits", "att"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_infer_step_triplets_parity(f32_models):
    """build_infer_step: valid masks and valid quintuples exactly equal,
    scores within 1e-5."""
    jmodel, params, model, _ = f32_models
    jb, tb = _batches(_records((6, 7, 8)))
    jtrip = jax.device_get(jax_infer_step(jmodel, topk=10)(params, jb))
    ttrip = build_infer_step(model, topk=10)(tb).numpy()
    np.testing.assert_array_equal(ttrip.valid, np.asarray(jtrip.valid))
    assert ttrip.valid.any()
    v = ttrip.valid
    np.testing.assert_array_equal(ttrip.quintuples[v],
                                  np.asarray(jtrip.quintuples)[v])
    np.testing.assert_array_equal(ttrip.dura_inters[v],
                                  np.asarray(jtrip.dura_inters)[v])
    np.testing.assert_array_equal(ttrip.query_ids,
                                  np.asarray(jtrip.query_ids))
    np.testing.assert_allclose(ttrip.scores, np.asarray(jtrip.scores),
                               atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_decoder_routes_role_attention(f32_models, monkeypatch, train):
    """Eval mode calls the kernel wrapper in every decoder layer (at any
    batch size); train mode calls the plain version."""
    calls = {"kernel": 0, "plain": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch_layers, "role_attention",
                        spy("kernel", torch_layers.role_attention))
    monkeypatch.setattr(torch_layers, "role_attention_plain",
                        spy("plain", torch_layers.role_attention_plain))
    model = f32_models[2]
    _, tb = _batches(_records((1,)))
    model.train(train)
    try:
        with torch.no_grad():
            model(tb)
    finally:
        model.eval()
    n = MODEL_CONFIG["n_deco_layers"]
    assert calls == ({"kernel": 0, "plain": n} if train
                     else {"kernel": n, "plain": 0})


def test_v7_is_not_ported_yet():
    """v7 is ported now (the cases below); what stays out is a variant the
    JAX package does not have, and v7's config switches keep their JAX
    meaning."""
    cfg = BigCConfig.from_dict(dict(MODEL_CONFIG, EntiNameEmb_path=None),
                               variant="v7")
    assert cfg.clsme_in_feats and not cfg.name_emb_in_head
    assert isinstance(BigC(cfg), BigC)
    with pytest.raises(ValueError, match="v10 or v7"):
        BigC(dataclasses.replace(cfg, variant="v8"))


# ---- v7 (BIG_C_vidor): frozen pos-table, MLP head, classeme switch --------

V7_CONFIG = parse_config_py(os.path.join(
    os.path.dirname(__file__), "..", "experiments", "demo",
    "config_vidor_.py"))["model_config"]
# (use_clsme, name table?): classeme from the name table, classeme channels
# in the features (the demo config), no classeme (exp4's head)
V7_CASES = {"v7_emb": (True, True), "v7_clsme": (True, False),
            "v7_noclsme": (False, False)}


def _v7_models(case, compute_dtype="float32"):
    use_clsme, name_table = V7_CASES[case]
    mc = dict(V7_CONFIG, use_clsme=use_clsme, compute_dtype=compute_dtype,
              EntiNameEmb_path="enti.npy" if name_table else None)
    jcfg = JaxBigCConfig.from_dict(mc, variant="v7")
    cfg = BigCConfig.from_dict(mc, variant="v7")
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(cfg.num_enti_cats, cfg.dim_clsme)).astype(
        np.float32)
    # a trained v7 checkpoint's frozen pos-table is random, not the sine one
    pos = rng.normal(0, 0.5, (cfg.num_querys, cfg.dim_pred)).astype(
        np.float32)
    jmodel = JaxBigC(jcfg, enti_name_emb=emb if name_table else None,
                     pos_emb_table=pos)
    jb, _ = _batches(_v7_records([0]))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jb))
    params["params"]["bias_matrix"] = rng.normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    tables = {"enti_name_emb": emb, "pos_emb_table": pos}
    model = BigC(cfg)
    model.load_state_dict(bigc_state_dict_from_jax(params, cfg, tables),
                          strict=True)
    return jmodel, params, model.eval(), tables


def _v7_records(seeds):
    # VidOR features: RoI channels, then 300 classeme channels
    return _records(seeds, V7_CONFIG["dim_feat"] + V7_CONFIG["dim_clsme"])


@pytest.fixture(scope="module", params=list(V7_CASES))
def v7_models(request):
    return request.param, _v7_models(request.param)


def test_v7_state_dict_round_trip(v7_models):
    """Exact round trip through bigc_params_from_torch, the frozen tables
    included; the converted keys are the port model's own (pos_embedding a
    buffer, EntiNameEmb only where the head reads it)."""
    case, (_, params, model, tables) = v7_models
    cfg = model.cfg
    sd = bigc_state_dict_from_jax(params, cfg, tables)
    assert set(sd) == set(model.state_dict())
    assert "pos_embedding" not in dict(model.named_parameters())
    assert ("EntiNameEmb" in sd) == (case == "v7_emb")
    back, back_tables = bigc_params_from_torch(
        sd, JaxBigCConfig.from_dict(dict(
            V7_CONFIG, use_clsme=V7_CASES[case][0]), variant="v7"))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    np.testing.assert_array_equal(back_tables["pos_emb_table"],
                                  tables["pos_emb_table"])


def test_v7_forward_parity_float32(v7_models):
    """float32, the v10 tolerance: within 1e-4."""
    _, models = v7_models
    jout, tout = _forward_both(models,
                               *_batches(_v7_records((1, 2))))
    for k in ("pred_logits", "att", "enti_feat", "pred_queries"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_v7_forward_parity_bfloat16():
    """bfloat16 compute, the v10 tolerances (logits 5e-2, att 1e-2)."""
    models = _v7_models("v7_clsme", "bfloat16")
    jout, tout = _forward_both(models,
                               *_batches(_v7_records((1, 2))))
    np.testing.assert_allclose(tout["pred_logits"], jout["pred_logits"],
                               atol=5e-2)
    np.testing.assert_allclose(tout["att"], jout["att"], atol=1e-2)


def test_v7_infer_step_triplets_parity(v7_models):
    """Valid masks, quintuples and windows exactly equal; scores 1e-5."""
    _, (jmodel, params, model, _) = v7_models
    jb, tb = _batches(_v7_records((6, 7, 8)))
    jtrip = jax.device_get(jax_infer_step(jmodel, topk=3)(params, jb))
    ttrip = build_infer_step(model, topk=3)(tb).numpy()
    np.testing.assert_array_equal(ttrip.valid, np.asarray(jtrip.valid))
    assert ttrip.valid.any()
    v = ttrip.valid
    np.testing.assert_array_equal(ttrip.quintuples[v],
                                  np.asarray(jtrip.quintuples)[v])
    np.testing.assert_array_equal(ttrip.dura_inters[v],
                                  np.asarray(jtrip.dura_inters)[v])
    np.testing.assert_allclose(ttrip.scores, np.asarray(jtrip.scores),
                               atol=1e-5)


def test_v7_sine_table_and_feature_width():
    """Without a table v7 uses the sine positions (as the JAX model); the
    classeme-in-features head needs exactly dim_feat + 300 channels, the
    others ignore a classeme tail."""
    from vidsgg_big_tpu.models.layers import (sine_pos_embedding as
                                              jax_sine)
    cfg = BigCConfig.from_dict(V7_CONFIG, variant="v7")
    np.testing.assert_array_equal(
        BigC(cfg).pos_embedding.numpy(),
        jax_sine(cfg.num_querys, cfg.dim_pred))
    _, tb = _batches(_v7_records((1,)))
    with pytest.raises(ValueError, match="feature dim"):
        BigC(cfg).eval()(tb.replace(feats=tb.feats[..., :-1]))
    exp4_head = BigC(dataclasses.replace(cfg, use_clsme=False)).eval()
    with torch.no_grad():
        assert torch.isfinite(exp4_head(tb)["pred_logits"]).all()
