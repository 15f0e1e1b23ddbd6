"""BIG-C training in the port against the JAX package on the CPU.

Shared numpy inputs go through both packages: the vIoU matrices, the GT
alignment, the matching cost, the assignment on one cost array, the loss
terms and every gradient (JAX params carried into the port with
``bigc_state_dict_from_jax``, the port's gradients carried back with
``bigc_params_from_torch``), and a 12-step Adam trajectory held inside the
envelope of tests/test_fused_trajectory.py.  Every comparison with JAX runs
at dropout 0 (JAX: ``deterministic=True``, the port: a train-mode model
whose dropout is 0): the two packages draw different random numbers.
Widths: 1 encoder + 2 decoder layers, dims 32, Q=16, N=12, T=32.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.data.types import (pack_gt as jax_pack_gt,
                                       pack_proposal as jax_pack,
                                       stack_batches as jax_stack)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.models.transplant import bigc_params_from_torch
from vidsgg_big_tpu.ops import boxes as jax_boxes
from vidsgg_big_tpu.ops.matching import hungarian as jax_hungarian
from vidsgg_big_tpu.train import losses as jax_losses
from vidsgg_big_tpu.train import train_state as jax_train_state
from vidsgg_big_tpu.train.steps import optax_global_norm

from vidsgg_big_tpu_torch.data.types import (pack_gt, pack_proposal,
                                             stack_batches)
from vidsgg_big_tpu_torch.models import layers
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.models.transplant import bigc_state_dict_from_jax
from vidsgg_big_tpu_torch.ops import boxes
from vidsgg_big_tpu_torch.ops.matching import hungarian
from vidsgg_big_tpu_torch.train import losses
from vidsgg_big_tpu_torch.train.steps import build_train_step
from vidsgg_big_tpu_torch.train.train_state import TrainState

MODEL_CONFIG = dict(
    num_pred_cats=20, num_enti_cats=12, dim_feat=32, dim_clsme=16,
    dim_enti=32, dim_pred=32, dim_att=32, dim_ffn=32, dim_i3d=16,
    enco_pool_len=4, n_enco_layers=1, n_deco_layers=2, n_att_head=4,
    num_querys=16, neg_weight=0.1, positive_vIoU_th=0.5,
    cost_coeff_dict=dict(classification=1.0, adj_matrix=30.0),
    loss_coeff_dict=dict(classification=1.0, adj_matrix=30.0))
FEAT = 48
N, T, G, P = 12, 32, 6, 8
T_ABS = 64
VIOU_TOL = dict(rtol=1e-5, atol=1e-6)


# ---- inputs ----------------------------------------------------------------

def _videos(seeds):
    return [make_video(s, video_len=48, n_gt_trajs=5, n_preds=6,
                       n_distractors=5, feat_dim=FEAT, num_enti_cats=12,
                       num_pred_cats=20) for s in seeds]


def _batches(vids):
    """The same records packed by both packages: (JAX props, JAX gts,
    port props, port gts)."""
    jp = jax_stack([jax_pack(p, N, T, FEAT) for p, _ in vids])
    jg = jax_stack([jax_pack_gt(g, G, T, P) for _, g in vids])
    tp = stack_batches([pack_proposal(p, N, T, FEAT) for p, _ in vids])
    tg = stack_batches([pack_gt(g, G, T, P) for _, g in vids])
    return jp, jg, tp.to("cpu"), tg.to("cpu")


def _trajectories(rng, b, k, t, hi, pad):
    """(boxes (b, k, t, 4), durations (b, k, 2), valid (b, k)): random-walk
    boxes over random spans (some longer than the stored ``t`` frames),
    the last ``pad`` of each video padding (zero boxes and durations)."""
    boxes_ = np.zeros((b, k, t, 4), np.float32)
    dura = np.zeros((b, k, 2), np.int32)
    valid = np.zeros((b, k), bool)
    for i in range(b):
        for j in range(k - pad):
            s = int(rng.integers(0, hi))
            length = int(rng.integers(1, t + 12))
            dura[i, j] = (s, s + length - 1)
            stored = min(length, t)
            xy = rng.uniform(0, 80, 2) + rng.normal(0, 2, (stored, 2)).cumsum(0)
            wh = rng.uniform(10, 40, 2)
            boxes_[i, j, :stored] = np.concatenate([xy, xy + wh], -1)
            valid[i, j] = True
    return boxes_, dura, valid


# ---- vIoU --------------------------------------------------------------------

@pytest.mark.parametrize("t_abs", [16, 40, 1024],
                         ids=["span_past_t_abs", "some_past", "covering"])
def test_viou_matrix_grid_matches_jax(t_abs):
    """Batched over 3 videos, 9 x 7 trajectories with spans past the stored
    frames, padding on both sides, non-overlapping pairs, and at t_abs=16
    and 40 frames past min(valid start) + t_abs: 1e-6 abs / 1e-5 rel."""
    rng = np.random.default_rng(t_abs)
    b1, d1, v1 = _trajectories(rng, 3, 9, 20, 60, pad=2)
    b2, d2, v2 = _trajectories(rng, 3, 7, 24, 60, pad=1)
    want = np.stack([np.asarray(jax_boxes.viou_matrix_grid(
        b1[i], d1[i], b2[i], d2[i], v1[i], v2[i], t_abs=t_abs))
        for i in range(3)])
    got = boxes.viou_matrix_grid(*map(torch.from_numpy, (
        b1, d1, b2, d2, v1, v2)), t_abs=t_abs).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **VIOU_TOL)
    assert (want[~v1] == 0).all() and (want.transpose(0, 2, 1)[~v2] == 0).all()
    assert (want == 0).sum() > (~v1).sum() * 7     # disjoint pairs occur
    assert (want > 0.1).any()
    if t_abs == 16:                 # the grid's cut changes some values
        full = boxes.viou_matrix_grid(*map(torch.from_numpy, (
            b1, d1, b2, d2, v1, v2)), t_abs=1024).numpy()
        assert not np.allclose(full, got)


def test_viou_matrix_matches_jax():
    """The gather version (windows clamped to the stored frames), with and
    without validity masks: 1e-6 abs / 1e-5 rel."""
    rng = np.random.default_rng(3)
    b1, d1, v1 = _trajectories(rng, 2, 8, 20, 40, pad=2)
    b2, d2, v2 = _trajectories(rng, 2, 6, 16, 40, pad=1)
    for masks in ((v1, v2), (None, None)):
        want = np.stack([np.asarray(jax_boxes.viou_matrix(
            b1[i], d1[i], b2[i], d2[i],
            *(None if m is None else m[i] for m in masks)))
            for i in range(2)])
        got = boxes.viou_matrix(
            *map(torch.from_numpy, (b1, d1, b2, d2)),
            *(None if m is None else torch.from_numpy(m)
              for m in masks)).numpy()
        np.testing.assert_allclose(got, want, **VIOU_TOL)
    assert np.asarray(jax_boxes.box_areas_xyxy(b1)).tolist() == \
        boxes.box_areas_xyxy(torch.from_numpy(b1)).numpy().tolist()


# ---- alignment, cost, matching -------------------------------------------------

def _rescue_batch():
    """Two videos; in the first, GT trajectory 2's boxes are moved so that
    no proposal reaches vIoU 0.5 with it (it must claim its best one)."""
    vids = _videos([11, 12])
    gt = vids[0][1]
    gt.traj_boxes[2] = gt.traj_boxes[2] + np.float32(25.0)
    return _batches(vids)


def test_align_gt_adjacency_matches_jax_exactly():
    jp, jg, tp, tg = _rescue_batch()
    want, want_v = map(np.asarray, jax_losses.align_gt_adjacency(
        jp, jg, 0.5, t_abs=T_ABS))
    got, got_v = losses.align_gt_adjacency(tp, tg, 0.5, t_abs=T_ABS)
    np.testing.assert_allclose(got_v.numpy(), want_v, **VIOU_TOL)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rescue ran: a valid GT trajectory without a positive proposal
    need = ((want_v > 0.5).sum(1) == 0) & np.asarray(jg.traj_mask)
    assert need[0, 2] and need.sum() >= 1
    assert want.sum() > 0


def _outputs(seed, b, q=16, c=20):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, q, c)).astype(np.float32)
    raw = rng.normal(0, 1.5, (b, 2, q, N))
    att = (np.exp(raw) / np.exp(raw).sum(-1, keepdims=True) *
           rng.uniform(0.3, 0.7, (b, 1, q, 1))).astype(np.float32)
    return logits, att


def test_matching_cost_matches_jax():
    jp, jg, tp, tg = _rescue_batch()
    logits, att = _outputs(0, 2)
    aligned = np.array(jax_losses.align_gt_adjacency(jp, jg, 0.5)[0])
    want = np.asarray(jax_losses.matching_cost(
        logits, att, jg, aligned, jp.traj_mask, 1.0, 30.0))
    got = losses.matching_cost(
        torch.from_numpy(logits), torch.from_numpy(att), tg,
        torch.from_numpy(aligned), tp.traj_mask, 1.0, 30.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the JAX package's matching cases (tests/test_ops.py:174-260): (seed, Q,
# P, n_gt per video)
HUNGARIAN_CASES = {
    "mixed": (6, 12, 7, (7, 3, 0, 1)),
    "more_gts_than_queries": (16, 5, 9, (8,)),
    "padded_p_over_q": (18, 6, 20, (0, 3, 6, 11, 20)),
    "n_gt_equals_q": (19, 6, 6, (6, 6)),
}


@pytest.mark.parametrize("case", list(HUNGARIAN_CASES))
def test_hungarian_matches_jax_exactly(case):
    """The same cost array to both solvers: equal assignments, -1 past
    n_gt, min(Q, n_gt) pairs."""
    seed, q, p, n_gt = HUNGARIAN_CASES[case]
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(len(n_gt), q, p)).astype(np.float32)
    n_gt = np.asarray(n_gt, np.int32)
    want = np.asarray(jax_hungarian(jnp.asarray(cost), jnp.asarray(n_gt)))
    got = hungarian(torch.from_numpy(cost), torch.from_numpy(n_gt))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for i, m in enumerate(n_gt):
        assert (want[i, m:] == -1).all()
        assert (want[i] >= 0).sum() == min(q, m)


def test_bigc_losses_match_jax_on_one_assignment():
    """The loss terms on shared predictions and one assignment (padding
    and unmatched gts included, a fully masked video): 1e-5."""
    jp, jg, tp, tg = _rescue_batch()
    mask = np.asarray(jp.traj_mask).copy()
    mask[1] = False                       # a remainder-padding repeat
    jp = jp.replace(traj_mask=mask)
    tp = tp.replace(traj_mask=torch.from_numpy(mask))
    logits, att = _outputs(1, 2)
    aligned = np.array(jax_losses.align_gt_adjacency(jp, jg, 0.5)[0])
    q4g = np.array([[3, 0, -1, 7, 9, 1, -1, -1], [-1] * 8], np.int64)
    want_total, want = jax_losses.bigc_losses(
        logits, att, jg, aligned, mask, jnp.asarray(q4g, jnp.int32), 16,
        0.1, 1.0, 30.0)
    total, got = losses.bigc_losses(
        torch.from_numpy(logits), torch.from_numpy(att), tg,
        torch.from_numpy(aligned), tp.traj_mask, torch.from_numpy(q4g), 16,
        0.1, 1.0, 30.0)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)


# ---- config and the model's dropout ------------------------------------------

def test_from_dict_keeps_the_loss_fields():
    for d in (MODEL_CONFIG, dict(
            MODEL_CONFIG, neg_weight=0.25, positive_vIoU_th=0.4,
            cost_coeff_dict=dict(classification=2.0, adj_matrix=10.0),
            loss_coeff_dict=dict(classification=3.0, adj_matrix=20.0)),
            {k: v for k, v in MODEL_CONFIG.items() if k not in (
                "neg_weight", "positive_vIoU_th", "cost_coeff_dict",
                "loss_coeff_dict")}):
        got, want = BigCConfig.from_dict(d), JaxBigCConfig.from_dict(d)
        for f in ("neg_weight", "positive_viou_th", "cost_coeff_cls",
                  "cost_coeff_adj", "loss_coeff_cls", "loss_coeff_adj"):
            assert getattr(got, f) == getattr(want, f), f
    assert BigCConfig.from_dict(dict(
        MODEL_CONFIG, neg_weight=0.25)).neg_weight == 0.25


@functools.lru_cache(maxsize=1)
def _jax_init():
    """The JAX model at dropout 0, its init (plus a random frequency-bias
    prior) and a random name-embedding table."""
    jcfg = dataclasses.replace(JaxBigCConfig.from_dict(MODEL_CONFIG),
                               dropout=0.0)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(12, 16)).astype(np.float32)
    jmodel = JaxBigC(jcfg, enti_name_emb=emb)
    jp, _, _, _ = _batches(_videos([0]))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jp))
    params["params"]["bias_matrix"] = rng.normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    return jcfg, jmodel, params, emb


def _models(dropout=0.0):
    """(JAX config, JAX model, params, the port model on the same weights
    at ``dropout``, name table)."""
    jcfg, jmodel, params, emb = _jax_init()
    cfg = dataclasses.replace(BigCConfig.from_dict(MODEL_CONFIG),
                              dropout=dropout)
    model = BigC(cfg)
    model.load_state_dict(bigc_state_dict_from_jax(
        params, cfg, {"enti_name_emb": emb}), strict=True)
    return jcfg, jmodel, params, model, emb


def test_reference_state_dict_still_loads_strict():
    """The decoder FFN keeps the reference's Sequential: parameters at
    fc2.0 and fc2.3, the generator-fed dropout module at index 2."""
    _, _, params, model, emb = _models()
    sd = bigc_state_dict_from_jax(params, model.cfg, {"enti_name_emb": emb})
    assert set(sd) == set(model.state_dict())
    assert {"decoder_layers.1.fc2.0.weight",
            "decoder_layers.1.fc2.3.bias"} <= set(sd)
    assert not any(".fc2.2." in k for k in sd)
    BigC(model.cfg).load_state_dict(sd, strict=True)
    assert isinstance(model.decoder_layers[0].fc2[2], layers.Dropout)


def test_dropouts_follow_the_generator():
    """Train mode at dropout 0.1: the loss is a function of the
    generator's state (same seed, same bits; another seed, another loss)
    and torch's global stream is not drawn from; eval mode draws
    nothing."""
    model = _models(dropout=0.1)[3]
    cfg = model.cfg
    _, _, tp, tg = _batches(_videos([1, 2]))

    def loss(seed):
        model.train()
        out = model(tp, generator=torch.Generator().manual_seed(seed))
        return losses.bigc_train_loss(out, tp, tg, cfg, t_abs=T_ABS)[0]

    state = torch.get_rng_state()
    with torch.no_grad():
        a, b, c = loss(4), loss(4), loss(5)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(7)
    before = g.get_state()
    with torch.no_grad():
        model.eval()(tp, generator=g)
    assert torch.equal(g.get_state(), before)


# ---- the training loss and its gradients -------------------------------------

@functools.lru_cache(maxsize=1)
def _jax_value_and_grad():
    jcfg, jmodel, _, _ = _jax_init()

    def loss_fn(p, jp, jg):
        out = jmodel.apply(p, jp, deterministic=True)
        return jax_losses.bigc_train_loss(out, jp, jg, jcfg, t_abs=T_ABS)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_loss_and_grads(params, jp, jg):
    (total, terms), grads = _jax_value_and_grad()(params, jp, jg)
    return float(total), {k: float(v) for k, v in terms.items()}, grads


def _jax_matching(jcfg, jmodel, params, jp, jg):
    """JAX's assignment and the cost it solved (its bigc_train_loss keeps
    both inside)."""
    jout = jmodel.apply(params, jp, deterministic=True)
    aligned = jax_losses.align_gt_adjacency(
        jp, jg, jcfg.positive_viou_th, t_abs=T_ABS)[0]
    jcost = jax_losses.matching_cost(
        jout["pred_logits"], jout["att"], jg, aligned, jp.traj_mask,
        jcfg.cost_coeff_cls, jcfg.cost_coeff_adj)
    n_gt = jnp.asarray(jg.pred_mask).sum(-1).astype(jnp.int32)
    return np.asarray(jax_hungarian(jcost, n_gt)), np.asarray(jcost)


def test_train_loss_and_grads_match_jax():
    """bigc_train_loss at dropout 0 on shared weights and records: the
    assignments equal, each loss term to 1e-5 relative, and every
    gradient leaf, carried back to the JAX tree, within 1e-3 of the leaf's
    largest magnitude, with an absolute floor of 1e-7: the attention key
    biases' gradients are rounding noise of 1e-10 around an exact 0 (a
    key bias moves every logit of a softmax row alike), as in
    tests/test_torch_grounding_train.py."""
    jcfg, jmodel, params, model, emb = _models()
    jp, jg, tp, tg = _batches(_videos([3, 4]))
    want_a, jcost = _jax_matching(jcfg, jmodel, params, jp, jg)
    model.train().zero_grad()
    total, terms, (got_a, tcost) = losses.bigc_train_loss(
        model(tp), tp, tg, model.cfg, t_abs=T_ABS)
    got_a = got_a.numpy()
    np.testing.assert_allclose(tcost.numpy(), jcost, rtol=1e-5, atol=1e-5)
    if not np.array_equal(want_a, got_a):
        gap = [float(sum(jcost[b, q, p] for p, q in enumerate(a[b]) if q >= 0)
                     for b in range(len(a))) for a in (want_a, got_a)]
        pytest.fail(f"assignments differ: JAX {want_a}, port {got_a}; cost "
                    f"of each under the JAX cost: {gap}")
    assert (want_a >= 0).sum() > 0

    want_total, want_terms, want_grads = _jax_loss_and_grads(
        params, jp, jg)
    total.backward()
    for k, v in want_terms.items():
        np.testing.assert_allclose(terms[k].item(), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), want_total, rtol=1e-5)
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          .numpy() for k, p in model.named_parameters()}
    sd["EntiNameEmb"] = emb
    got = bigc_params_from_torch(sd, jcfg)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        w, g = np.asarray(w), np.asarray(flat_g[path])
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= 1e-3 * scale + 1e-7, (
            jax.tree_util.keystr(path), np.abs(g - w).max(), scale)


def test_train_step_metrics_match_jax():
    """One build_train_step update: the metrics (loss terms, total and the
    pre-clip global gradient norm) against JAX's to 1e-5, and the updated
    parameters against optax's clip + Adam applied to the port's own
    gradients, to 1e-5 of each leaf's scale: optax takes Adam's bias
    corrections in float32 (1 - 0.999 rounds 1.3e-5 off), torch in float64,
    which moves a first update by 6.5e-6 of itself, the whole scale of a
    zero-initialised bias.  (Adam's first update is about lr x sign(g), so
    on the attention key biases, whose gradients are rounding noise around
    0, the two packages' own gradients would give updates of either
    sign.)"""
    jcfg, jmodel, params, model, emb = _models()
    jp, jg, tp, tg = _batches(_videos([6, 7]))
    total, terms, grads = _jax_loss_and_grads(params, jp, jg)
    probe = BigC(model.cfg)
    probe.load_state_dict(model.state_dict())
    losses.bigc_train_loss(probe.train()(tp), tp, tg, probe.cfg,
                           t_abs=T_ABS)[0].backward()
    sd = {k: p.grad.numpy() for k, p in probe.named_parameters()}
    sd["EntiNameEmb"] = emb
    port_grads = bigc_params_from_torch(sd, jcfg)[0]
    start_params = bigc_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)[0]
    tx, _ = jax_train_state.make_optimizer(1e-3, 0.2, [8])
    up, _ = tx.update(port_grads, tx.init(start_params), start_params)
    new = optax.apply_updates(start_params, up)

    state = TrainState(model, 1e-3, 0.2, [8])
    metrics = build_train_step(model, state, t_abs=T_ABS)(tp, tg)
    assert set(metrics) == {"cls_pos", "cls_neg", "adj", "total",
                            "grad_norm"}
    assert state.step == 1
    for k, v in dict(terms, total=total).items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(optax_global_norm(grads)), rtol=1e-5)
    got = bigc_params_from_torch(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        jcfg)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(new)[0]:
        w, g = np.asarray(w), np.asarray(flat_g[path])
        scale = float(np.abs(w).max()) + 1e-12
        assert np.abs(g - w).max() <= 1e-5 * scale, jax.tree_util.keystr(
            path)


# ---- a 12-step trajectory ------------------------------------------------------

def test_train_trajectory_inside_the_envelope():
    """12 clipped-Adam steps of the port against JAX at dropout 0, on the
    same data and init.  Float32 rounding (~1e-7 relative per op) grows
    through the training dynamics and the matching, so the bound is the
    system's own: the port's summed relative loss divergence stays within
    2x what a 1e-5 parameter perturbation causes on the JAX path
    (tests/test_fused_trajectory.py:59-125), with strict parity at step 0."""
    jcfg, jmodel, params, model, _ = _models()
    jp, jg, tp, tg = _batches(_videos([8, 9]))
    steps = 12
    tx, _ = jax_train_state.make_optimizer(1e-3, 0.2, [8])

    @jax.jit
    def jstep(p, opt):
        def loss_fn(pp):
            out = jmodel.apply(pp, jp, deterministic=True)
            return jax_losses.bigc_train_loss(out, jp, jg, jcfg,
                                              t_abs=T_ABS)
        (total, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, opt2 = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt2, total

    def jax_run(p):
        opt, out = tx.init(p), []
        for _ in range(steps):
            p, opt, total = jstep(p, opt)
            out.append(float(total))
        return np.asarray(out)

    leaves, tree = jax.tree_util.tree_flatten(params)
    ks = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    pert = jax.tree_util.tree_unflatten(tree, [
        l + 1e-5 * np.asarray(jax.random.normal(k, l.shape))
        for l, k in zip(leaves, ks)])
    l_jax, l_pert = jax_run(params), jax_run(pert)

    step = build_train_step(model, TrainState(model, 1e-3, 0.2, [8]),
                            t_abs=T_ABS)
    l_port = np.asarray([step(tp, tg)["total"].item()
                         for _ in range(steps)])

    assert l_jax[-1] < 0.9 * l_jax[0]           # it trains
    rel_port = np.abs(l_port - l_jax) / np.abs(l_jax)
    rel_pert = np.abs(l_pert - l_jax) / np.abs(l_jax)
    assert rel_port[0] < 1e-5, rel_port
    assert rel_port.sum() <= 2.0 * rel_pert.sum(), (rel_port, rel_pert)
