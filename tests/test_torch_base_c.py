"""Base-C in the PyTorch port against the JAX package on the CPU.

Weights come from the JAX model's init (plus a random frequency-bias prior
and name table), carried into the port by ``basec_state_dict_from_jax``;
both models see the same numpy-packed records at the demo VidOR config's
widths (64 RoI + 300 classeme channels, 12 tracklets in a 16 bucket).
"""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.data.types import (pack_gt as jax_pack_gt,
                                       pack_proposal as jax_pack,
                                       stack_batches as jax_stack)
from vidsgg_big_tpu.models import base_c as jax_base_c
from vidsgg_big_tpu.models.transplant import basec_params_from_torch
from vidsgg_big_tpu.models.triplets import (
    pairwise_construct_triplets as jax_pairwise)
from vidsgg_big_tpu.train.steps import (
    build_basec_infer_step as jax_basec_infer_step)
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data.types import (pack_gt, pack_proposal,
                                             stack_batches)
from vidsgg_big_tpu_torch.models.base_c import (BaseC, BaseCConfig,
                                                basec_multihot,
                                                basec_train_loss,
                                                ordered_pair_ids)
from vidsgg_big_tpu_torch.models.big_c import load_bias_matrix
from vidsgg_big_tpu_torch.models.transplant import basec_state_dict_from_jax
from vidsgg_big_tpu_torch.models.triplets import pairwise_construct_triplets
from vidsgg_big_tpu_torch.train.steps import (build_basec_infer_step,
                                              build_basec_train_step)
from vidsgg_big_tpu_torch.train.train_state import TrainState

REPO = os.path.join(os.path.dirname(__file__), "..")
MC = parse_config_py(os.path.join(REPO, "experiments", "demo",
                                  "config_vidor_.py"))["model_config"]
FEAT = MC["dim_feat"] + MC["dim_clsme"]
N_BUCKET, T_BUCKET, G_BUCKET, P_BUCKET = 16, 64, 8, 16
# (use_clsme, name table): classeme channels in the features (exp6's
# head), the name-embedding head, no classeme
CASES = {"clsme": (True, False), "name_emb": (True, True),
         "noclsme": (False, False)}


def _videos(seeds):
    return [make_video(s, video_len=60, n_gt_trajs=6, n_preds=8,
                       n_distractors=6, feat_dim=FEAT, num_enti_cats=81,
                       num_pred_cats=51) for s in seeds]


def _batches(seeds, dtype=np.float32):
    """The same records packed by both packages: ((JAX props, gts), (port
    props, gts))."""
    vids = _videos(seeds)
    jp = jax_stack([jax_pack(p, N_BUCKET, T_BUCKET, FEAT, dtype=dtype)
                    for p, _ in vids])
    jg = jax_stack([jax_pack_gt(g, G_BUCKET, T_BUCKET, P_BUCKET)
                    for _, g in vids])
    tp = stack_batches([pack_proposal(p, N_BUCKET, T_BUCKET, FEAT,
                                      dtype=dtype) for p, _ in vids])
    tg = stack_batches([pack_gt(g, G_BUCKET, T_BUCKET, P_BUCKET)
                        for _, g in vids])
    return (jp, jg), (tp.to("cpu"), tg.to("cpu"))


def _models(case="clsme", **overrides):
    use_clsme, name_table = CASES[case]
    mc = dict(MC, use_clsme=use_clsme,
              EntiNameEmb_path="enti.npy" if name_table else None)
    jcfg = dataclasses.replace(jax_base_c.BaseCConfig.from_dict(mc),
                               **overrides)
    cfg = dataclasses.replace(BaseCConfig.from_dict(mc), **overrides)
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(cfg.num_enti_cats, cfg.dim_clsme)).astype(
        np.float32)
    jmodel = jax_base_c.BaseC(jcfg, enti_name_emb=emb if name_table
                              else None)
    (jp, _), _ = _batches([0])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jp))
    params["params"]["bias_matrix"] = rng.normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    tables = {"enti_name_emb": emb}
    model = BaseC(cfg)
    model.load_state_dict(basec_state_dict_from_jax(params, cfg, tables),
                          strict=True)
    return jmodel, params, model, tables


@pytest.fixture(scope="module", params=list(CASES))
def models(request):
    return request.param, _models(request.param)


def test_config_and_pair_ids_match_jax():
    for name in ("config_.py", "config_rt200.py"):
        mc = parse_config_py(os.path.join(REPO, "experiments", "exp6",
                                          name))["model_config"]
        assert dataclasses.asdict(BaseCConfig.from_dict(mc)) == \
            dataclasses.asdict(jax_base_c.BaseCConfig.from_dict(mc))
    for n in (2, 5, 16):
        np.testing.assert_array_equal(ordered_pair_ids(n),
                                      jax_base_c.ordered_pair_ids(n))


def test_state_dict_round_trip(models):
    """basec_params_from_torch(basec_state_dict_from_jax(p)) == p exactly
    (the pooled flatten's channel-major order included), and the keys are
    the port model's own."""
    case, (_, params, model, tables) = models
    cfg = model.cfg
    sd = basec_state_dict_from_jax(params, cfg, tables)
    assert set(sd) == set(model.state_dict())
    assert ("EntiNameEmb" in sd) == (case == "name_emb")
    back, back_tables = basec_params_from_torch(sd, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if case == "name_emb":
        np.testing.assert_array_equal(back_tables["enti_name_emb"],
                                      tables["enti_name_emb"])


def test_forward_matches_jax(models):
    """pred_logits within 1e-4 (float32 sums in another order); pair ids,
    pair masks exactly equal; node embeddings within 1e-4."""
    _, (jmodel, params, model, _) = models
    (jp, _), (tp, _) = _batches([1, 2])
    jout = jmodel.apply(params, jp)
    with torch.no_grad():
        tout = model.eval()(tp)
    np.testing.assert_array_equal(tout["pair_ids"].numpy(),
                                  np.asarray(jout["pair_ids"]))
    np.testing.assert_array_equal(tout["pair_mask"].numpy(),
                                  np.asarray(jout["pair_mask"]))
    for k in ("pred_logits", "enti_feat"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_bias_table_loads_into_base_c():
    model = BaseC(BaseCConfig.from_dict(MC))
    bias = np.random.default_rng(0).normal(size=(81, 81, 51))
    load_bias_matrix(model, bias)
    np.testing.assert_array_equal(model.bias_matrix.detach().numpy(),
                                  bias.astype(np.float32))


@pytest.mark.parametrize("t_abs", [64, 1024])
def test_multihot_matches_jax(t_abs):
    """The label maps exactly equal to JAX's, with positive pairs present."""
    (jp, jg), (tp, tg) = _batches([1, 2, 3])
    jm, jpos = basec_multihot(tp, tg, 51, 0.5, t_abs=t_abs)
    em, epos = jax_base_c.basec_multihot(jp, jg, 51, 0.5, t_abs=t_abs)
    np.testing.assert_array_equal(jm.numpy(), np.asarray(em))
    np.testing.assert_array_equal(jpos.numpy(), np.asarray(epos))
    assert jpos.any()


def _jax_loss_and_grads(jmodel, params, jp, jg, cfg, t_abs):
    def loss_fn(p):
        return jax_base_c.basec_train_loss(jmodel.apply(p, jp), jp, jg,
                                           cfg, t_abs=t_abs)
    (total, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(total), jax.tree_util.tree_map(np.asarray, grads)


def _check_grads(model, jgrads, tables, bf16_leaves=()):
    """Every gradient leaf within 1e-3 of its scale (1e-7 floor); the JAX
    gradient tree is carried to the port's names by the (linear) layout
    conversion of the weights.  Leaves whose layer runs in bfloat16 hold
    within 2e-2 of their scale: their gradients are bf16 sums over every
    frame row (2,048 here), which the two frameworks accumulate and round
    in another order (1.6% of the scale at most here, on a bias)."""
    want = basec_state_dict_from_jax(jgrads, model.cfg, tables)
    for k, p in model.named_parameters():
        g, w = p.grad.numpy(), want[k].numpy()
        scale = np.abs(w).max()
        tol = 2e-2 if k.startswith(bf16_leaves) else 1e-3
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=max(tol * scale, 1e-7), err_msg=k)


@pytest.mark.parametrize("case", ["clsme", "noclsme"])
def test_loss_and_gradients_match_jax(case):
    """The BCE over positive pairs within 1e-5 of JAX's, every gradient
    leaf within 1e-3 of its scale."""
    jmodel, params, model, tables = _models(case)
    (jp, jg), (tp, tg) = _batches([4, 5])
    jtotal, jgrads = _jax_loss_and_grads(jmodel, params, jp, jg,
                                         model.cfg, 4096)
    model.train()
    total, terms = basec_train_loss(model(tp), tp, tg, model.cfg,
                                    t_abs=4096)
    total.backward()
    assert terms["cls"] is total
    assert total.item() == pytest.approx(jtotal, rel=1e-5)
    _check_grads(model, jgrads, tables)


def test_int8_forward_and_training_gradient_match_jax():
    """int8 storage: the forward within 1e-4 of JAX's int8 forward.  In
    train mode Base-C (unlike BIG-C) does not dequantize up front, so the
    first visual layer runs int8 and its weight gets gradient only through
    its scale's max (JAX's quirk, reproduced): the gradients equal JAX's
    within 1e-3 of each leaf."""
    jmodel, params, model, tables = _models("clsme")
    (jp, jg), (tp, tg) = _batches([4, 5], dtype=np.int8)
    assert tp.feats.dtype == torch.int8
    jout = jmodel.apply(params, jp)
    with torch.no_grad():
        tout = model.eval()(tp)
    np.testing.assert_allclose(tout["pred_logits"].numpy(),
                               np.asarray(jout["pred_logits"]), rtol=1e-4,
                               atol=1e-4)
    jtotal, jgrads = _jax_loss_and_grads(jmodel, params, jp, jg,
                                         model.cfg, 1024)
    model.train()
    total, _ = basec_train_loss(model(tp), tp, tg, model.cfg)
    total.backward()
    assert total.item() == pytest.approx(jtotal, rel=1e-5)
    # the int8 first layer returns bf16, so fc_feat2enti runs in bf16
    _check_grads(model, jgrads, tables, bf16_leaves=("fc_feat2enti.",))
    g = model.fc_feat2enti[0].weight.grad
    # one entry per output row (its max |w|) carries the gradient
    assert ((g != 0).sum(1) <= 1).all() and (g != 0).any()


@pytest.mark.parametrize("rt_topk", [0, 3])
def test_pairwise_triplets_match_jax(rt_topk):
    """Equal valid sets, quintuples and windows; scores within 1e-6."""
    rng = np.random.default_rng(5)
    b, n, c, topk = 2, 6, 8, 2
    pair_ids = ordered_pair_ids(n)
    logits = rng.normal(size=(b, pair_ids.shape[0], c)).astype(np.float32)
    starts = rng.integers(0, 20, (b, n))
    durs = np.stack([starts, starts + rng.integers(5, 30, (b, n))],
                    -1).astype(np.int32)
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    cats = rng.integers(0, 5, (b, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    mask[1, -2:] = False
    trip = pairwise_construct_triplets(
        *map(torch.from_numpy, (logits, pair_ids, durs, scores, cats, mask)),
        topk=topk, num_enti_cats=5, num_pred_cats=c, rt_topk=rt_topk).numpy()
    for i in range(b):
        j = jax.device_get(jax_pairwise(
            logits[i], pair_ids, durs[i], scores[i], cats[i], mask[i],
            topk=topk, num_enti_cats=5, num_pred_cats=c, rt_topk=rt_topk))
        np.testing.assert_array_equal(trip.valid[i], np.asarray(j.valid))
        np.testing.assert_array_equal(trip.quintuples[i],
                                      np.asarray(j.quintuples))
        np.testing.assert_array_equal(trip.dura_inters[i],
                                      np.asarray(j.dura_inters))
        np.testing.assert_array_equal(trip.query_ids[i],
                                      np.asarray(j.query_ids))
        np.testing.assert_allclose(trip.scores[i], np.asarray(j.scores),
                                   atol=1e-6)
    if rt_topk:
        assert (trip.valid.sum(1) <= rt_topk).all()
        assert trip.valid.sum() > 0


def test_infer_step_matches_jax():
    """build_basec_infer_step at exp6's rt200 rule scaled down (rt_topk 20,
    topk 3): valid masks, quintuples exactly equal, scores within 1e-5."""
    jmodel, params, model, _ = _models("clsme", rt_triplets_topk=20)
    (jp, _), (tp, _) = _batches([6, 7])
    jtrip = jax.device_get(jax_basec_infer_step(jmodel, topk=3)(params, jp))
    ttrip = build_basec_infer_step(model, topk=3)(tp).numpy()
    np.testing.assert_array_equal(ttrip.valid, np.asarray(jtrip.valid))
    assert ttrip.valid.any() and (ttrip.valid.sum(1) <= 20).all()
    v = ttrip.valid
    np.testing.assert_array_equal(ttrip.quintuples[v],
                                  np.asarray(jtrip.quintuples)[v])
    np.testing.assert_allclose(ttrip.scores, np.asarray(jtrip.scores),
                               atol=1e-5)


def test_train_step_metrics():
    """One build_basec_train_step update: cls == total, a finite pre-clip
    norm, and the parameters move."""
    _, _, model, _ = _models("clsme")
    (_, _), (tp, tg) = _batches([1, 2])
    state = TrainState(model, 1e-3, 0.2, [100])
    before = model.fc_pred2logits[0].weight.detach().clone()
    metrics = build_basec_train_step(model, state, t_abs=4096)(tp, tg)
    assert set(metrics) == {"cls", "total", "grad_norm"}
    assert metrics["cls"].item() == metrics["total"].item() > 0
    assert np.isfinite(metrics["grad_norm"].item())
    assert not torch.equal(before, model.fc_pred2logits[0].weight)
