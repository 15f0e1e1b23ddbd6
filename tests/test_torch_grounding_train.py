"""Grounding training in the port against the JAX package on the CPU.

Shared numpy inputs go through both packages: the label geometry and the
loss on the same predictions, the train-time query construction on JAX's
own Gumbel draw, the stored-softmax chunked attention, the full training
loss and its gradients (JAX params carried into the port with
``grounding_state_dict_from_jax``, the port's gradients carried back with
``grounding_params_from_torch``), the optimizer against optax, and a
12-step Adam trajectory held inside the envelope of
tests/test_fused_trajectory.py.  Every comparison with JAX runs at dropout 0
(JAX: ``deterministic=True``, the port: a train-mode model whose dropout and
attention dropout are 0): the two packages draw different random numbers.
"""
import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.data.types import pack_gt, stack_batches
from vidsgg_big_tpu.models import grounding as jax_grounding
from vidsgg_big_tpu.models.transplant import grounding_params_from_torch
from vidsgg_big_tpu.ops import attention as jax_attention
from vidsgg_big_tpu.ops import temporal as jax_temporal
from vidsgg_big_tpu.train import grounding_data as jax_grounding_data
from vidsgg_big_tpu.train import grounding_steps as jax_steps
from vidsgg_big_tpu.train import train_state as jax_train_state
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data.types import GraphBatch
from vidsgg_big_tpu_torch.models import grounding
from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                   GroundingModel)
from vidsgg_big_tpu_torch.models.transplant import (
    grounding_state_dict_from_jax)
from vidsgg_big_tpu_torch.ops import attention
from vidsgg_big_tpu_torch.ops.temporal import tiou_left_right
from vidsgg_big_tpu_torch.train.grounding_data import prepare_grounding_gt
from vidsgg_big_tpu_torch.train.grounding_steps import (
    build_grounding_train_step, grounding_train_loss)
from vidsgg_big_tpu_torch.train.train_state import (TrainState,
                                                    clip_by_global_norm,
                                                    milestone_lr)

DEMO = parse_config_py(os.path.join(
    os.path.dirname(__file__), "..", "experiments", "demo",
    "config_grounding_.py"))["model_config"]
NO_DROP = dict(attn_dropout=0.0)
# the demo widths (dim_hidden 32: direct and chunked attention) and the
# composed geometry (dim_hidden 128, T = 128, a 1 MiB budget: the combined
# encoder's 2 x 2P rows take the composed path in both packages)
DEMO_CFG = dict(DEMO, dim_feat=48, **NO_DROP)
WIDE_CFG = dict(DEMO, dim_feat=48, dim_hidden=128, attn_bytes_budget=1 << 20,
                **NO_DROP)
B, P = 2, 8


def _gts(b=B, p_bucket=P, seed=7, t=64):
    """JAX-packed GT graphs of ``b`` synthetic videos (numpy leaves)."""
    vids = [make_video(seed + i, video_len=60 + 9 * i, n_gt_trajs=4,
                       n_preds=6, num_enti_cats=81, num_pred_cats=51,
                       feat_dim=4) for i in range(b)]
    gts = stack_batches([pack_gt(g, 6, 64, p_bucket) for _, g in vids])
    video_len = np.array([g.video_len for _, g in vids], np.int64)
    return gts, video_len


def _port_gts(gts):
    return GraphBatch(**{k: torch.from_numpy(np.asarray(v))
                         for k, v in vars(gts).items()})


def _batch(cfg_dict, t, seed=0):
    rng = np.random.default_rng(seed)
    n_clips = np.array([t, t - 9][:B], np.int64)
    clip_mask = np.arange(t)[None] < n_clips[:, None]
    feats = (rng.normal(size=(B, t, cfg_dict["dim_feat"])) *
             clip_mask[..., None]).astype(np.float32)
    gts, video_len = _gts(t=t)
    return feats, clip_mask, n_clips, gts, video_len


def _jax_noise(rng, b, p, c):
    """The Gumbel draw jax_steps.grounding_train_loss makes from ``rng``."""
    rng_neg, _ = jax.random.split(rng)
    keys = jax.random.split(rng_neg, b)
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (p, c)))(keys))


def _models(cfg_dict, t):
    cfg_dict = dict(cfg_dict, fused_interpret=True)
    jcfg = jax_grounding.GroundingConfig.from_dict(cfg_dict)
    jmodel = jax_grounding.GroundingModel(jcfg)
    feats, clip_mask, _, gts, video_len = _batch(cfg_dict, t)
    prep = jax.vmap(functools.partial(
        jax_grounding_data.prepare_grounding_gt,
        num_pred_cats=jcfg.num_pred_cats))(
        gts, video_len.astype(np.int32),
        rng=jax.random.split(jax.random.PRNGKey(0), B))
    params = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(1), feats, clip_mask, prep["query_cats"],
        prep["temporal"], prep["query_mask"]))
    # the heads' final kernels x 0.02 (the JAX stable_head_init): at the
    # reference init the logits saturate near +-200, where float32 noise
    # alone is 1e-3
    for head in ("regr_head", "conf_head", "cls_head"):
        params["params"][head]["out"]["point_wise"]["kernel"] *= 0.02
    # the JAX layers' own dropout (0.1) is off under deterministic=True; the
    # port's train-mode model runs at dropout 0 instead
    model = GroundingModel(dataclasses.replace(
        GroundingConfig.from_dict(cfg_dict), dropout=0.0))
    model.load_state_dict(grounding_state_dict_from_jax(params), strict=True)
    return jmodel, params, model


# ---- label geometry, loss, query construction --------------------------------

def test_tiou_left_right_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(0, 0.5, (3, 7, 2)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        tiou_left_right(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_temporal.tiou_left_right(a, b)), rtol=1e-6)


@pytest.mark.parametrize("num_bins", [4, 10])
def test_gt_labels_match_jax(num_bins):
    rng = np.random.default_rng(1)
    s = rng.uniform(0, 0.7, (3, 5))
    target = np.stack([s, s + rng.uniform(0.01, 0.3, (3, 5))],
                      -1).astype(np.float32)
    target[0, 0] = [0.2, 0.4]            # a centre on a bin edge
    n_clips = np.array([40, 17, 1], np.int64)
    want = jax.vmap(lambda tg, n: jax_grounding.grounding_gt_labels(
        tg, n, 48, num_bins))(target, n_clips.astype(np.int32))
    got = grounding.grounding_gt_labels(torch.from_numpy(target),
                                        torch.from_numpy(n_clips), 48,
                                        num_bins)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _loss_inputs(seed=2, b=2, q=6, t=20, k=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 2, s).astype(np.float32)
    out = (rng.uniform(0, 1, (b, q, t, 2, k)).astype(np.float32),
           f(b, q, t, k), f(b, q, t, k))
    neg = (rng.uniform(0, 1, (b, q, t, 2, k)).astype(np.float32),
           f(b, q, t, k), f(b, q, t, k))
    s = rng.uniform(0, 0.6, (b, q))
    target = np.stack([s, s + rng.uniform(0.05, 0.4, (b, q))],
                      -1).astype(np.float32)
    n_clips = np.array([t, t - 5][:b], np.int64)
    group_rep = np.array([[0, 0, 2, 3, 2, 5], [0, 1, 1, 3, 4, 4]])
    is_rep = group_rep == np.arange(q)[None]
    query_mask = np.ones((b, q), bool)
    query_mask[1, -1] = False
    is_rep &= query_mask
    clip_mask = np.arange(t)[None] < n_clips[:, None]
    return out, neg, target, n_clips, group_rep, is_rep, query_mask, \
        clip_mask


def test_grounding_loss_matches_jax():
    """Every loss term on the same predictions and labels, to 1e-6
    relative (float32 sums in another order)."""
    out, neg, target, n_clips, grp, is_rep, qm, cm = _loss_inputs()
    t, k = cm.shape[1], out[1].shape[-1]
    jcfg = jax_grounding.GroundingConfig(num_bins=k, loss_cls=1.5,
                                         loss_reg=0.5)
    labels = jax.vmap(lambda tg, n: jax_grounding.grounding_gt_labels(
        tg, n, t, k))(target, n_clips.astype(np.int32))
    want_total, want = jax_grounding.grounding_loss(
        out, neg, labels, grp.astype(np.int32), is_rep, qm, cm, jcfg)
    T = torch.from_numpy
    cfg = GroundingConfig(num_bins=k, loss_cls=1.5, loss_reg=0.5)
    plabels = grounding.grounding_gt_labels(T(target), T(n_clips), t, k)
    total, got = grounding.grounding_loss(
        [T(a) for a in out], [T(a) for a in neg], plabels, T(grp), T(is_rep),
        T(qm), T(cm), cfg)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-6)


def test_prepare_grounding_gt_matches_jax():
    """Integer outputs equal and spans equal, given JAX's own Gumbel draw;
    padded slots and duplicate queries included."""
    gts, video_len = _gts(b=3, p_bucket=12, seed=11)
    # a duplicate of slot 0 (same tag) in the first video
    gts.pred_cats[0, 6] = gts.pred_cats[0, 0]
    gts.pred_durations[0, 6] = gts.pred_durations[0, 0]
    gts.adj[0, :, 6] = gts.adj[0, :, 0]
    gts.pred_mask[0, 6] = True
    rng = jax.random.PRNGKey(3)
    keys = jax.random.split(rng, 3)
    want = jax.vmap(functools.partial(
        jax_grounding_data.prepare_grounding_gt, num_pred_cats=51))(
        gts, video_len.astype(np.int32), rng=keys)
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (12, 51)))(
        keys))
    got = prepare_grounding_gt(_port_gts(gts), torch.from_numpy(video_len),
                               51, noise=torch.from_numpy(noise))
    assert not bool(np.asarray(want["is_rep"])[0, 6])
    for name in ("query_cats", "neg_query_cats", "is_rep", "group_rep",
                 "query_mask"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("temporal", "target"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


# ---- stored-softmax chunked attention --------------------------------------

def test_pack_bits_round_trip():
    keep = torch.rand(3, 5, 19) < 0.6
    packed = attention._pack_bits(keep)
    assert packed.shape == (3, 5, 3) and packed.dtype == torch.uint8
    torch.testing.assert_close(attention._unpack_bits(packed, 19), keep)
    want = np.asarray(jax_attention._pack_bits(jnp.asarray(keep.numpy())))
    np.testing.assert_array_equal(packed.numpy(), want)


def test_keep_mask16_realizes_the_16_bit_rate():
    p = 0.1
    eff = attention.drop_rate_eff(p)
    assert eff == jax_attention.drop_rate_eff(p) == round(p * 65536) / 65536
    keep = attention.keep_mask16((64, 8, 64, 64), p,
                                 torch.Generator().manual_seed(0), "cpu")
    q = 1 - eff
    sigma = np.sqrt(q * (1 - q) / keep.numel())
    assert abs(keep.float().mean().item() - q) < 4 * sigma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_stored_grads_match_jax(dtype):
    """attn_chunked_stored: output and gradients of q, k, v against the
    JAX stored-softmax VJP at dropout 0, a fully masked row included
    (float32 1e-5; bf16 1e-2: the stored softmax and the products round to
    bf16 in both, after float32 sums in another order)."""
    rng = np.random.default_rng(4)
    b, t, h, hd = 4, 24, 2, 8
    q, k, v, cot = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
                    for _ in range(4))
    mask = rng.random((b, t)) < 0.8
    mask[:, 0] = True
    mask[-1] = False
    jdt = getattr(jnp, dtype)

    def f(qq, kk, vv):
        o = jax_attention.attn_chunked_stored(qq, kk, vv, jnp.asarray(mask),
                                              chunk=2)
        return (o.astype(jnp.float32) * cot).sum(), o
    (_, jo), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    o = attention.attn_chunked_stored(tq, tk, tv, torch.from_numpy(mask),
                                      chunk=2)
    (o.float() * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(jo, np.float32), **tol)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


def test_chunked_stored_dropout_backward_uses_the_stored_mask():
    """With dropout the output is linear in v for the stored mask:
    f(v + E) - f(v) = <df/dv, E> with the forward's generator state."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 16, 2, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.ones(4, 16, dtype=torch.bool)
    eps = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)) * .1
    f = lambda vv, s: attention.attn_chunked_stored(
        q, k, vv, mask, chunk=2, dropout=0.3,
        generator=torch.Generator().manual_seed(s)).sum()
    vg = v.clone().requires_grad_()
    f(vg, 1).backward()
    lhs = float(f(v + eps, 1) - f(v, 1))
    rhs = float((vg.grad * eps).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4, (lhs, rhs)
    torch.testing.assert_close(f(v, 1), f(v, 1), rtol=0, atol=0)


# ---- the layer's gate --------------------------------------------------------

def test_train_mode_takes_the_composed_path():
    """As JAX's use_fused (models/grounding.py:309-320): a layer in train
    mode over budget at 128-aligned shapes calls fused_composed_attention
    once, with dropout = attn_dropout; flash_attention alone does not take
    it while attention dropout is drawn."""
    calls = []
    real = grounding.fused_composed_attention
    x = torch.randn(8, 128, 128)
    mask = torch.ones(8, 128, dtype=torch.bool)
    try:
        grounding.fused_composed_attention = \
            lambda *a, **k: calls.append(k["dropout"]) or real(*a, **k)
        for fused, flash, want in [(True, False, [0.25]),
                                   (False, True, [])]:
            calls.clear()
            layer = grounding.QANetEncoderLayer(
                128, 4, 7, attn_dropout=0.25, attn_bytes_budget=1 << 20,
                fused_attention=fused, flash_attention=flash).train()
            with torch.no_grad():
                layer(x, mask, generator=torch.Generator().manual_seed(0))
            assert calls == want, (fused, flash)
    finally:
        grounding.fused_composed_attention = real


def test_layer_dropouts_follow_the_generator():
    """Train-mode outputs are a function of the generator's state."""
    layer = grounding.QANetEncoderLayer(32, 4, 7).train()
    with torch.no_grad():
        for prm in layer.parameters():
            prm.normal_(0.0, 0.1)
    x = torch.randn(3, 20, 32)
    run = lambda s: layer(x, generator=torch.Generator().manual_seed(s))
    with torch.no_grad():
        torch.testing.assert_close(run(4), run(4), rtol=0, atol=0)
        assert not torch.equal(run(4), run(5))


# ---- the training loss and its gradients -------------------------------------

def _jax_loss_and_grads(jmodel, params, batch, rng):
    feats, clip_mask, n_clips, gts, video_len = batch

    def loss_fn(p):
        return jax_steps.grounding_train_loss(
            jmodel, p, feats, clip_mask, n_clips.astype(np.int32), gts,
            video_len.astype(np.int32), rng, deterministic=True)
    (total, terms), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return float(total), {k: float(v) for k, v in terms.items()}, grads


def _port_loss_and_grads(model, batch, noise):
    feats, clip_mask, n_clips, gts, video_len = batch
    model.train().zero_grad()
    total, terms = grounding_train_loss(
        model, torch.from_numpy(feats), torch.from_numpy(clip_mask),
        torch.from_numpy(n_clips), _port_gts(gts),
        torch.from_numpy(video_len), noise=torch.from_numpy(noise))
    total.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return total.item(), {k: v.item() for k, v in terms.items()}, grads


@pytest.mark.parametrize("cfg_dict,t", [(DEMO_CFG, 32), (WIDE_CFG, 128)],
                         ids=["demo", "composed"])
def test_train_loss_and_grads_match_jax(cfg_dict, t, monkeypatch):
    """grounding_train_loss at dropout 0: each loss term to 1e-5 relative;
    every gradient, carried back to the JAX tree, within 1e-3 of the
    leaf's largest magnitude plus 1e-3 relative (float32 sums in another
    order through 3 QANet blocks, the fusion and 3 conv heads), with an
    absolute floor of 1e-7: b_k's gradient is rounding noise of 1e-10 on
    the direct path (exactly 0 on the composed one).  On the composed geometry the combined
    encoder takes the composed path in both packages."""
    calls = []
    real = grounding.fused_composed_attention
    monkeypatch.setattr(grounding, "fused_composed_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jmodel, params, model = _models(cfg_dict, t)
    batch = _batch(cfg_dict, t, seed=1)
    rng = jax.random.PRNGKey(5)
    noise = _jax_noise(rng, B, P, 51)
    want_total, want_terms, want_grads = _jax_loss_and_grads(
        jmodel, params, batch, rng)
    total, terms, grads = _port_loss_and_grads(model, batch, noise)
    assert len(calls) == (1 if cfg_dict is WIDE_CFG else 0)
    for name, v in want_terms.items():
        np.testing.assert_allclose(terms[name], v, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(total, want_total, rtol=1e-5)
    got = grounding_params_from_torch({k: g.numpy() for k, g in
                                       grads.items()})
    flat_w = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        w = np.asarray(w)
        g = np.asarray(flat_g[path])
        scale = float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


# ---- optimizer ---------------------------------------------------------------

def test_clip_adam_and_schedule_match_optax():
    """TrainState (global-norm clip 5.0, Adam, milestone schedule) against
    the JAX make_optimizer on toy params over 6 updates, two of them
    clipped and two past a milestone (float32: 1e-6 relative)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (10 if i < 2 else 0.5)).astype(
        np.float32) for k, s in shapes.items()} for i in range(6)]
    tx, sched = jax_train_state.make_optimizer(1e-2, 0.2, [2, 4])
    params, opt = {k: jnp.asarray(v) for k, v in init.items()}, None
    opt = tx.init(params)
    for g in grads:
        up, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                            params)
        params = optax.apply_updates(params, up)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    state = TrainState(module, 1e-2, 0.2, [2, 4])
    for g in grads:
        for k, v in g.items():
            getattr(module, k).grad = torch.tensor(v)
        state.apply_gradients()
    assert state.step == 6
    for k in shapes:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for s in range(7):
        assert milestone_lr(1e-2, 0.2, [2, 4], s) == pytest.approx(
            float(sched(s)), rel=1e-6)
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # norm 13
    norm = clip_by_global_norm(g, 5.0)
    assert norm.item() == pytest.approx(13.0)
    want = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray([3.0, 4.0]), jnp.asarray([12.0])], None)[0]
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


# ---- a 12-step trajectory ------------------------------------------------------

def test_train_trajectory_inside_the_envelope():
    """12 clipped-Adam steps of the port against the JAX chunked path at
    dropout 0, on the same data, init and Gumbel draws.  Float32 rounding
    (~1e-7 relative per op) grows through the training dynamics, so the
    bound is the system's own: the port's summed relative loss divergence
    stays within 2x what a 1e-5 parameter perturbation causes on the JAX
    path (tests/test_fused_trajectory.py:59-125), with strict parity at
    step 0."""
    cfg_dict = dict(DEMO_CFG, attn_bytes_budget=1 << 14,
                    fused_attention=False)
    t, steps = 32, 12
    jmodel, params, model = _models(cfg_dict, t)
    feats, clip_mask, n_clips, gts, video_len = _batch(cfg_dict, t, seed=2)
    tx, _ = jax_train_state.make_optimizer(3e-4, 0.2, [8])

    @jax.jit
    def jstep(p, opt, rng):
        def loss_fn(pp):
            return jax_steps.grounding_train_loss(
                jmodel, pp, feats, clip_mask, n_clips.astype(np.int32), gts,
                video_len.astype(np.int32), rng, deterministic=True)
        (total, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, opt2 = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt2, total

    rngs = [jax.random.fold_in(jax.random.PRNGKey(42), i)
            for i in range(steps)]

    def jax_run(p):
        opt, losses = tx.init(p), []
        for r in rngs:
            p, opt, total = jstep(p, opt, r)
            losses.append(float(total))
        return np.asarray(losses)

    leaves, tree = jax.tree_util.tree_flatten(params)
    ks = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    pert = jax.tree_util.tree_unflatten(tree, [
        l + 1e-5 * np.asarray(jax.random.normal(k, l.shape))
        for l, k in zip(leaves, ks)])
    l_jax, l_pert = jax_run(params), jax_run(pert)

    state = TrainState(model, 3e-4, 0.2, [8])
    step = build_grounding_train_step(model, state)
    tb = (torch.from_numpy(feats), torch.from_numpy(clip_mask),
          torch.from_numpy(n_clips), _port_gts(gts),
          torch.from_numpy(video_len))
    l_port = np.asarray([step(*tb, noise=torch.from_numpy(
        _jax_noise(r, B, P, 51)))["total"].item() for r in rngs])

    assert l_jax[-1] < 0.9 * l_jax[0]           # it trains
    rel_port = np.abs(l_port - l_jax) / np.abs(l_jax)
    rel_pert = np.abs(l_pert - l_jax) / np.abs(l_jax)
    assert rel_port[0] < 1e-5, rel_port
    assert rel_port.sum() <= 2.0 * rel_pert.sum(), (rel_port, rel_pert)
