"""Sharded dry run of the port's train and inference steps, each held
against the single-process run.

Port of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``
(:83-219).  At n ranks it lays out a 2-D (n/2) x 2 (data x model) mesh
when n >= 4 and even, a 1-D data mesh otherwise, and runs JAX's four
phases, one step each, printing JAX's four phase lines:

  1. the BIG-C train step: the batch split over the data ranks, the MLPs,
     FFNs and attention heads over the model ranks, dropout at the
     config's rate, global-mean losses;
  2. BIG-C inference on the same layout, the triplets gathered;
  3. the grounding train step over the data axis (the model is never split),
     the composed attention's row seeds cut from the global batch's;
  4. grounding (stage-B) inference over the data axis.

Each phase's result (the loss, the updated parameters gathered whole, the
gradients, the triplets, the decoded spans) is compared with the same step
in one process on the same seeds: the losses to rtol 1e-4, the parameters
to rtol 1e-3, atol 1e-5 (the JAX test's, ``tests/test_parallel.py:45-52``),
the gradients to 1e-3 of their leaf's largest, triplet scores and grounding
outputs to 1e-5.  A ReLU or max-pool input within rounding of its kink
sends its gradient another way when the batch's size changes how a
product rounds (cuBLAS picks its kernels by the shape), so the sharded
train steps take the one-process step's max-pool picks and ReLU signs in
their backward (:class:`Kinks`), and their own picks and signs are held
apart: each that differs must be a tie, its reference input no farther
from the kink than the two runs' inputs differ elsewhere on it.  Run as

    python -m vidsgg_big_tpu_torch.tools.dryrun_multichip N \\
        [--device cuda|cpu] [--backend gloo|nccl] [--widths small|full]

``--widths small`` (the default) takes JAX's dry-run widths for BIG-C and a
128-wide grounding model whose attention takes the composed path;
``full`` takes exp2's BIG-C and grounding_weights at bench.py's geometry.
On the card ``--backend gloo`` puts every rank on ``cuda:0`` (several
ranks on one card: NCCL takes one rank per card).  The phase functions
(``bigc_train`` ...) take ``mesh=None`` for the single-process run; the
tests drive them under their own meshes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..data.synthetic import clip_features, make_video, num_clips
from ..data.transfer import tree_map
from ..data.types import pack_gt, pack_proposal, stack_batches
from ..models import big_c
from ..models.base_c import BaseC, BaseCConfig
from ..models.big_c import BigC, BigCConfig
from ..models.grounding import GroundingConfig, GroundingModel
from ..parallel.mesh import run_ranks, shard_rows
from ..parallel.sharding import shard_params
from ..train.grounding_steps import (build_grounding_infer_step,
                                     build_grounding_train_step)
from ..train.steps import (build_basec_infer_step, build_basec_train_step,
                           build_infer_step, build_train_step)
from ..train.train_state import TrainState
from ..utils.device import strict_float32

LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
# the gradients of a sharded step: within this share of their leaf's
# largest
GRAD_RTOL = 1e-3
LR = 1e-4
# a sharded step's own max-pool picks and ReLU signs against the
# one-process step's: at most this share of a kink's bins or inputs may
# differ (chip_smoke.py's limit for the card against the CPU), each a tie
# (Kinks.ties)
FLIP_SHARE = 1e-4
# the grounding outputs on the card (see compare)
CARD_OUT_TOL = dict(rtol=0.0, atol=2e-3)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 0


@dataclasses.dataclass(frozen=True)
class Problem:
    """The models and batches of a dry run: ``videos`` per data rank."""
    widths: str
    n_data: int
    videos: int = 2

    @property
    def batch(self) -> int:
        return self.videos * self.n_data

    def bigc_cfg(self) -> BigCConfig:
        if self.widths == "full":
            from ..utils.config import parse_config_py
            mc = parse_config_py("experiments/exp2/config_.py")[
                "model_config"]
            return BigCConfig.from_dict(mc, variant="v10")
        # JAX's dry-run BIG-C (__graft_entry__.py:_flagship at :128-130)
        return BigCConfig(num_pred_cats=10, num_enti_cats=12, dim_feat=32,
                          dim_enti=32, dim_pred=32, dim_att=32, dim_ffn=32,
                          dim_i3d=8, n_enco_layers=1, n_deco_layers=2,
                          n_att_head=4, num_querys=16)

    def basec_cfg(self) -> BaseCConfig:
        return BaseCConfig(num_pred_cats=10, num_enti_cats=12, dim_feat=32,
                           dim_clsme=8, dim_enti=32, dim_ffn=32,
                           use_name_emb=True)

    def grounding_cfg(self, fused: bool = True) -> GroundingConfig:
        if self.widths == "full":
            from ..utils.config import parse_config_py
            mc = parse_config_py("experiments/grounding_weights/config_.py")[
                "model_config"]
            return dataclasses.replace(GroundingConfig.from_dict(mc),
                                       fused_attention=fused)
        # 128 wide, T=128 and a 1 MiB logit budget: the video and combined
        # encoders take the composed path (its plain twin on the CPU)
        return GroundingConfig(dim_feat=32, dim_clsme=16, dim_hidden=128,
                               num_bins=4, attn_bytes_budget=1 << 20,
                               fused_attention=fused)

    # ---- batches (numpy / CPU tensors of the whole batch) ---------------

    def tracklet_batch(self, cfg, gt: bool = True):
        if self.widths == "full":
            from ..data.synthetic_vidvrd import (BENCH_GT_BUCKETS,
                                                 FULL_SIZE_RECIPE)
            recipe, (n, t) = FULL_SIZE_RECIPE, (50, 256)
            gb = BENCH_GT_BUCKETS
        else:
            recipe, (n, t) = dict(video_len=64), (8, 32)
            gb = dict(g_bucket=8, tg_bucket=32, p_bucket=16)
        width = cfg.dim_feat + (getattr(cfg, "dim_i3d", None) or 0)
        vids = [make_video(SEED + i, feat_dim=width,
                           num_enti_cats=cfg.num_enti_cats,
                           num_pred_cats=cfg.num_pred_cats, **recipe)
                for i in range(self.batch)]
        props = stack_batches([pack_proposal(p, n, t, width)
                               for p, _ in vids]).to("cpu")
        if not gt:
            return props
        return props, stack_batches([pack_gt(g, **gb)
                                     for _, g in vids]).to("cpu")

    def grounding_batch(self):
        """(feats, clip_mask, n_clips, gts, video_len) as train_vidor packs
        them."""
        from .train_vidor import make_batch
        cfg = self.grounding_cfg()
        video_len, t, p = (2400, 512, 64) if self.widths == "full" else \
            (1000, 128, 8)
        rows = []
        for i in range(self.batch):
            _, g = make_video(SEED + 100 + i, video_len=video_len,
                              n_gt_trajs=6, n_preds=p // 2,
                              num_enti_cats=cfg.num_enti_cats,
                              num_pred_cats=cfg.num_pred_cats, feat_dim=4)
            rows.append((clip_features(SEED + i, video_len, cfg.dim_feat),
                         g))
        return make_batch(rows, t, self.batch, cfg.dim_feat, p,
                          torch.float32)

    def grounding_queries(self):
        """Stage-B operands (feats, clip_mask, n_clips, query_cats,
        temporal, query_mask), the last video's last queries masked."""
        cfg = self.grounding_cfg()
        b = self.batch
        video_len, t, q = (2400, 512, 128) if self.widths == "full" else \
            (1000, 128, 16)
        rng = np.random.default_rng(SEED)
        n = num_clips(video_len)
        feats = np.zeros((b, t, cfg.dim_feat), np.float32)
        feats[:, :n] = rng.normal(size=(b, n, cfg.dim_feat))
        clips = np.full((b,), n, np.int64)
        cats = np.stack([rng.integers(1, cfg.num_enti_cats, (b, q)),
                         rng.integers(1, cfg.num_pred_cats, (b, q)),
                         rng.integers(1, cfg.num_enti_cats, (b, q))], -1)
        s = rng.uniform(0, 0.6, (b, q))
        temporal = np.stack([s, s + rng.uniform(0.05, 0.4, (b, q))], -1)
        qm = np.ones((b, q), bool)
        qm[-1, q // 2:] = False
        return tuple(torch.from_numpy(np.asarray(x)) for x in (
            feats, np.arange(t)[None] < clips[:, None], clips, cats,
            temporal.astype(np.float32), qm))


def _local(tree, mesh, device):
    """This rank's rows of a whole batch, on ``device``."""
    if mesh is not None:
        tree = shard_rows(tree, mesh)
    return tree_map(lambda x: x.to(device), tree)


def _host(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _step_generator():
    return torch.Generator().manual_seed(SEED + 1)


def _cut(full, local, mesh):
    """This rank's part of ``full`` (a one-process tensor) at the shape of
    ``local``: a shorter last dim is the model rank's block (a split
    layer's features), any other shorter dim the data rank's rows."""
    for d, (a, b) in enumerate(zip(full.shape, local.shape)):
        if a == b:
            continue
        parts, i = ((mesh.n_model, mesh.model_index) if d == full.ndim - 1
                    else (mesh.n_data, mesh.data_index))
        if a != b * parts:
            raise ValueError(f"cannot cut {tuple(full.shape)} to this "
                             f"rank's {tuple(local.shape)}")
        full = full.narrow(d, i * b, b)
    return full


def _bins(x, out_len, axis):
    """(x with its pooled axis split into (out_len, bin), the bin's dim)."""
    ax = axis % x.ndim
    length = x.shape[ax]
    if length % out_len:
        raise ValueError(f"the max-pool routing takes even bins; {length} "
                         f"frames into {out_len}")
    return x.reshape(x.shape[:ax] + (out_len, length // out_len)
                     + x.shape[ax + 1:]), ax + 1


def _routing(b, d):
    """How torch.amax's backward spreads each bin's gradient over the bin
    (dim ``d`` of ``b``): 1 / #maxima at each maximum, 0 elsewhere."""
    top = b == b.amax(d, keepdim=True)
    return (top / top.sum(d, keepdim=True)).to(b.dtype)


class Kinks:
    """A train step's kinks, in call order: the tracklet encoder's time
    max-pool (``big_c.adaptive_max_pool1d``) and every ReLU (``F.relu``,
    which ``nn.ReLU`` calls too), each input kept (detached).  Given
    ``ref`` (another run's :meth:`record`: the one-process step's, the whole
    batch), each backward takes that run's picks and signs, cut to this
    rank's rows and features (``mesh``); the forward stays this run's
    own."""

    def __init__(self, ref=None, mesh=None):
        self.ref, self.mesh, self.inputs = ref, mesh, []

    def _seen(self, kind, x, args=()):
        """The reference's input of this kink, cut to this rank's (None
        without a reference)."""
        i = len(self.inputs)
        self.inputs.append((kind, x.detach(), args))
        if self.ref is None:
            return None
        if i >= len(self.ref) or self.ref[i][0] != kind:
            raise AssertionError(f"kink {i} ({kind}) has no counterpart in "
                                 "the reference step")
        return self._local(self.ref[i][1], x)

    def _local(self, full, x):
        if self.mesh is not None:
            full = _cut(full, x, self.mesh)
        return full.to(x.device)

    @contextlib.contextmanager
    def installed(self):
        """Route the step's kinks through this object while inside."""
        pool0, relu0 = big_c.adaptive_max_pool1d, F.relu

        def pool(x, out_len, axis=-2):
            ref = self._seen("pool", x, (out_len, axis))
            if ref is None:
                return pool0(x, out_len, axis)
            (b, d), (rb, _) = _bins(x, out_len, axis), _bins(ref, out_len,
                                                              axis)
            return b.detach().amax(d) + ((b - b.detach())
                                         * _routing(rb, d)).sum(d)

        def relu(x, inplace=False):
            ref = self._seen("relu", x)
            if ref is None:
                return relu0(x, inplace)
            return relu0(x).detach() + (x - x.detach()) * (ref > 0).to(
                x.dtype)

        big_c.adaptive_max_pool1d, F.relu = pool, relu
        try:
            yield self
        finally:
            big_c.adaptive_max_pool1d, F.relu = pool0, relu0

    def record(self):
        """[(kind, input on the CPU, args)] of the kinks seen."""
        return [(k, x.cpu(), a) for k, x, a in self.inputs]

    def ties(self) -> list:
        """Per kink, this run's own picks or signs against the reference's:
        [kind, bins or inputs that differ, their number, the gap: the
        widest between the reference's values at the two picks (a ReLU:
        the reference's largest |input| among the flips), the spread: the
        largest |input - the reference's| where the two agree, both over
        the reference's largest |input|, and gap / spread], summed (the
        rest: the largest) over the ranks.  A difference is a tie where
        its gap lies within the spread: the reference's input there is no
        farther from the kink than the two runs' inputs differ at the
        kink's other bins or inputs."""
        rows = []
        for (kind, x, args), (_, full, _) in zip(self.inputs, self.ref):
            r = self._local(full, x)
            scale = max(full.abs().max().item(), 1e-30)
            if kind == "relu":
                flipped = (x > 0) != (r > 0)
                gap = r[flipped].abs().max().item() if flipped.any() else 0.0
                apart = (x - r).abs()[~flipped]
            else:
                (b, d), (rb, _) = _bins(x, *args), _bins(r, *args)
                own = _routing(b, d)
                flipped = (own != _routing(rb, d)).any(d)
                gap = (rb.amax(d) - torch.where(own > 0, rb, math.inf).amin(
                    d)).max().item()
                apart = (b - rb).abs().masked_fill(
                    flipped.unsqueeze(d), 0.0)
            spread = apart.max().item() if apart.numel() else 0.0
            ratio = gap / spread if spread else (math.inf if gap else 0.0)
            rows.append([kind, int(flipped.sum()), flipped.numel(),
                         gap / scale, spread / scale, ratio])
        if self.mesh is not None:
            import torch.distributed as dist
            counts = torch.tensor([r[1:3] for r in rows], dtype=torch.int64)
            gaps = torch.tensor([r[3:] for r in rows], dtype=torch.float64)
            dist.all_reduce(counts, group=self.mesh.host_group)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX,
                            group=self.mesh.host_group)
            rows = [[r[0], *c, *g] for r, c, g in zip(
                rows, counts.tolist(), gaps.tolist())]
        return rows


def check_ties(name, rows):
    """Raise unless every kink of ``rows`` (:meth:`Kinks.ties`) differs in
    at most FLIP_SHARE of its bins or inputs, each a tie."""
    for i, (kind, flips, n, gap, spread, ratio) in enumerate(rows):
        if flips > FLIP_SHARE * n or ratio > 1.0:
            raise AssertionError(
                f"{name} kink {i} ({kind}): {flips} of {n} differ from the "
                f"one-process step's (at most {FLIP_SHARE * n:.1f}), a gap "
                f"up to {gap} of the largest input against the inputs' "
                f"spread {spread} elsewhere (a tie lies within it)")


def _train(model, mesh, device, build, operands, kinks=None):
    model = model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    state = TrainState(model, LR, 0.2, [1000], mesh=mesh)
    step = build(model, state)
    with kinks.installed() if kinks else contextlib.nullcontext():
        metrics = step(*operands, generator=_step_generator())
    sd = state.state_dict()                # whole, on every rank
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    # after one step Adam's first moment is (1 - beta1) x the (clipped)
    # gradient
    grads = {name: sd["optimizer"]["state"][i]["exp_avg"] / (1 - beta1)
             for i, name in enumerate(state.names)}
    return {"loss": float(metrics["total"]),
            "terms": {k: float(v) for k, v in metrics.items()},
            "params": _host(sd["model"]), "grads": _host(grads),
            "sync_bytes": state.sync_bytes}


def bigc_model(p: Problem) -> BigC:
    cfg = p.bigc_cfg()
    emb = np.random.default_rng(SEED).normal(
        0, 0.1, (cfg.num_enti_cats, cfg.dim_clsme)).astype(np.float32)
    return BigC(cfg, enti_name_emb=emb,
                generator=torch.Generator().manual_seed(SEED))


def basec_model(p: Problem) -> BaseC:
    cfg = p.basec_cfg()
    emb = np.random.default_rng(SEED).normal(
        0, 0.1, (cfg.num_enti_cats, cfg.dim_clsme)).astype(np.float32)
    return BaseC(cfg, enti_name_emb=emb,
                 generator=torch.Generator().manual_seed(SEED))


def grounding_model(p: Problem, fused: bool = True) -> GroundingModel:
    return GroundingModel(p.grounding_cfg(fused),
                          generator=torch.Generator().manual_seed(SEED))


def bigc_train(p: Problem, mesh=None, device="cuda", kinks=None) -> dict:
    """One BIG-C train step (dropout at the config's rate); ``kinks``
    (:class:`Kinks`) sees or routes its kinks."""
    t_abs = 1024 if p.widths == "full" else 64
    return _train(bigc_model(p), mesh, device,
                  lambda m, s: build_train_step(m, s, t_abs=t_abs),
                  _local(p.tracklet_batch(p.bigc_cfg()), mesh, device),
                  kinks)


def basec_train(p: Problem, mesh=None, device="cuda", kinks=None) -> dict:
    """One Base-C train step."""
    return _train(basec_model(p), mesh, device,
                  lambda m, s: build_basec_train_step(m, s, t_abs=64),
                  _local(p.tracklet_batch(p.basec_cfg()), mesh, device),
                  kinks)


def grounding_train(p: Problem, mesh=None, device="cuda", kinks=None,
                    fused: bool = True) -> dict:
    """One grounding train step over the data axis (dropout 0.1)."""
    return _train(grounding_model(p, fused), mesh, device,
                  build_grounding_train_step,
                  _local(p.grounding_batch(), mesh, device), kinks)


def _infer(model, mesh, device, build, operands, tp=True):
    model = model.to(device)
    if mesh is not None and tp:
        shard_params(model, mesh)
    return _host(build(model)(*operands))


def bigc_infer(p: Problem, mesh=None, device="cuda"):
    """BIG-C inference: the whole batch's triplets."""
    return _infer(bigc_model(p), mesh, device,
                  lambda m: build_infer_step(m, topk=4, mesh=mesh),
                  (_local(p.tracklet_batch(p.bigc_cfg(), gt=False), mesh,
                          device),))


def basec_infer(p: Problem, mesh=None, device="cuda"):
    """Base-C inference: the whole batch's triplets."""
    return _infer(basec_model(p), mesh, device,
                  lambda m: build_basec_infer_step(m, topk=4, mesh=mesh),
                  (_local(p.tracklet_batch(p.basec_cfg(), gt=False), mesh,
                          device),))


def grounding_infer(p: Problem, mesh=None, device="cuda"):
    """Stage-B inference over the data axis: (pooled, bins_probs,
    bins_mask) of the whole batch."""
    return _infer(grounding_model(p), mesh, device,
                  lambda m: build_grounding_infer_step(
                      m, score_th=0.0, tiou_th=0.5, bins_th=0.0, nms_th=0.8,
                      mesh=mesh),
                  _local(p.grounding_queries(), mesh, device), tp=False)


PHASES = {"bigc_train": bigc_train, "bigc_infer": bigc_infer,
          "grounding_train": grounding_train,
          "grounding_infer": grounding_infer}
TRAIN = ("bigc_train", "basec_train", "grounding_train")


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from ..ops.composed_attn import (composed_attention,
                                     composed_attention_backward,
                                     composed_attention_train)
    from ..ops.role_attn import role_attention
    return {f.__name__: f.launches for f in (
        role_attention, composed_attention, composed_attention_train,
        composed_attention_backward)}


def _rank_phases(spec, mesh):
    """A rank's run of ``spec`` = (problem, phase names, device, {train
    phase: the one-process step's kink record}): {phase: result} of the
    sharded phases (a train step's with its kinks' ``ties``), and the
    kernel launches summed over the ranks under ``"launches"``."""
    import torch.distributed as dist
    p, names, device, refs = spec
    if mesh.device.type == "cuda":
        strict_float32()
    before = kernel_launches()
    out = {}
    for name in names:
        if name not in TRAIN:
            out[name] = PHASES[name](p, mesh, mesh.device)
            continue
        kinks = Kinks(refs[name], mesh)
        out[name] = PHASES[name](p, mesh, mesh.device, kinks=kinks)
        out[name]["ties"] = kinks.ties()
    counts = {k: v - before[k] for k, v in kernel_launches().items()}
    t = torch.tensor(list(counts.values()))
    dist.all_reduce(t, group=mesh.host_group)
    out["launches"] = dict(zip(counts, t.tolist()))
    return out


def _max_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def compare(name: str, sharded, single, card: bool = False) -> dict:
    """Hold a sharded phase's result against the single run's; raises
    past the tolerances.  Returns its largest differences.

    A train step's loss agrees within ``LOSS_RTOL``, its gradients (from
    Adam's first moment) within ``GRAD_RTOL`` of their leaf's largest, its
    updated parameters within ``PARAM_TOL``, and its kinks' own picks and
    signs, where it routed them (``ties``), are ties (:func:`check_ties`);
    inference outputs within ``OUT_TOL``, the triplets' picks and the bins'
    masks exactly.  On the card a row's products round by the batch's size,
    so a gradient element within that rounding of 0 takes either sign, and
    Adam's first step, lr x g / (|g| + eps), moves its parameter by lr x
    sign(g): there an updated parameter may miss ``PARAM_TOL`` by 2 lr at
    most where the one-process gradient lies within ``GRAD_RTOL`` of its
    leaf's largest of 0 (the gradients are held to that much), counted
    (``adam_ties``).  Grounding outputs are held to ``CARD_OUT_TOL`` there,
    the card-vs-CPU limit of its regression sigmoids (the random-init heads
    amplify rounding)."""
    if isinstance(single, dict):                       # a train step
        np.testing.assert_allclose(sharded["loss"], single["loss"],
                                   rtol=LOSS_RTOL, err_msg=name)
        grad_err, ties, signs = 0.0, 0, 0
        for k, g in single["grads"].items():
            got = sharded["grads"][k]
            if not np.isfinite(got).all():
                raise AssertionError(f"{name} gradient {k}: not finite")
            scale = max(float(np.abs(g).max()), 1e-30)
            err = _max_err(got, g)
            grad_err = max(grad_err, err / scale)
            signs += int((np.sign(got) != np.sign(g)).sum())
            if err > GRAD_RTOL * scale:
                raise AssertionError(f"{name} gradient {k}: max |diff| "
                                     f"{err}, max |g| {scale}")
        for k, v in single["params"].items():
            a = sharded["params"][k]
            diff = np.abs(np.asarray(a, np.float64) - v)
            off = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(v)
            if not off.any():
                continue
            g = single["grads"].get(k)
            tie = card and g is not None and diff[off].max() <= 2 * LR and (
                np.abs(g[off]) <= GRAD_RTOL * np.abs(g).max()).all()
            if not tie:
                np.testing.assert_allclose(a, v, err_msg=f"{name} {k}",
                                           **PARAM_TOL)
            ties += int(off.sum())
        out = {"loss": abs(sharded["loss"] - single["loss"]),
               "grads": grad_err, "grad_sign_flips": signs,
               "adam_ties": ties,
               "params": max(_max_err(sharded["params"][k], v)
                             for k, v in single["params"].items())}
        if "ties" in sharded:
            check_ties(name, sharded["ties"])
            rows = sharded["ties"]
            out.update(kink_flips=sum(r[1] for r in rows),
                       kink_gap=max((r[3] for r in rows), default=0.0),
                       kink_spread=max((r[4] for r in rows), default=0.0),
                       kink_gap_over_spread=max((r[5] for r in rows),
                                                default=0.0))
        return out
    if isinstance(single, tuple):                      # grounding outputs
        errs = {}
        for i, key in enumerate(("pooled", "bins_probs")):
            np.testing.assert_allclose(sharded[i], single[i],
                                       err_msg=f"{name} {key}",
                                       **(CARD_OUT_TOL if card else OUT_TOL))
            errs[key] = _max_err(sharded[i], single[i])
        np.testing.assert_array_equal(sharded[2], single[2])
        return errs
    np.testing.assert_array_equal(sharded.valid, single.valid)
    np.testing.assert_array_equal(sharded.quintuples, single.quintuples)
    np.testing.assert_allclose(sharded.scores, single.scores,
                               err_msg=f"{name} scores", **OUT_TOL)
    return {"scores": _max_err(sharded.scores, single.scores)}


def layout(n: int) -> tuple:
    """(data ranks, model ranks) of the dry run at n ranks."""
    tp = 2 if n >= 4 and n % 2 == 0 else 1
    return n // tp, tp


def dryrun(n: int, device="cuda", backend=None, widths: str = "small",
           names=tuple(PHASES), log=print, reference=None) -> dict:
    """Run ``names`` in one process and over n ranks (a train step's kinks
    routed as the one process's, :class:`Kinks`), compare (with the card's
    limits on the card, :func:`compare`), and print JAX's phase lines.
    ``reference`` ({(problem, phase): (result, kink record)}, filled here)
    keeps the one-process results for the next layout with the same batch.
    Returns {"errors": {phase: largest differences}, "launches": kernel
    launches of the sharded phases, "sharded": ...}."""
    n_data, n_model = layout(n)
    # full widths: one video a data rank (the grounding batch's 128 rows a
    # video already take the composed path)
    p = Problem(widths, n_data, videos=1 if widths == "full" else 2)
    dev = torch.device(device)
    if dev.type == "cuda":
        strict_float32()
    reference = {} if reference is None else reference
    for name in names:
        if (p, name) in reference:
            continue
        if name in TRAIN:
            kinks = Kinks()
            reference[(p, name)] = (PHASES[name](p, None, dev, kinks=kinks),
                                    kinks.record())
            del kinks               # its inputs on the card, before the ranks
        else:
            reference[(p, name)] = (PHASES[name](p, None, dev), None)
    if dev.type == "cuda":
        # the ranks may share this card: hand its cached blocks back
        torch.cuda.empty_cache()
    refs = {name: reference[(p, name)][1] for name in names}
    shared = dev.type == "cuda" and (backend or "nccl") == "gloo"
    sharded = run_ranks(_rank_phases, (p, list(names), device, refs),
                        n_data, n_model, device, backend=backend,
                        shared_device=shared, threads=1)
    errors = {}
    shape = (f"{n_data}x{n_model} data x model" if n_model > 1
             else f"{n_data} data")
    for i, name in enumerate(names):
        errors[name] = compare(name, sharded[name], reference[(p, name)][0],
                               card=dev.type == "cuda")
        log(_phase_line(n, i + 1, len(names), name, shape, n_model, p,
                        sharded[name], errors[name]))
    return {"errors": errors, "launches": sharded["launches"],
            "sharded": sharded, "layout": [n_data, n_model],
            "batch": p.batch}


def _phase_line(n, i, total, name, shape, n_model, p, res, err):
    head = f"dryrun_multichip({n}): [{i}/{total}]"
    if name == "bigc_train":
        return (f"{head} BIG-C sharded train step OK ({shape}), "
                f"loss={res['loss']:.4f}, step=1; vs one process {err}")
    if name == "bigc_infer":
        return (f"{head} BIG-C sharded inference OK ({shape}, TP params="
                f"{n_model > 1}); vs one process {err}")
    if name == "grounding_train":
        return (f"{head} grounding sharded train step OK (data axis "
                f"{p.batch}), loss={res['loss']:.4f}; vs one process {err}")
    return (f"{head} grounding sharded inference OK (data axis {p.batch}, "
            f"outputs gathered); vs one process {err}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=8,
                        help="ranks (default 8, as JAX's dry run)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default): one rank per card with "
                             "NCCL, every rank on cuda:0 with --backend "
                             "gloo; or cpu")
    parser.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    parser.add_argument("--widths", default="small",
                        choices=("small", "full"))
    args = parser.parse_args(argv)
    out = dryrun(args.n, args.device, args.backend, args.widths)
    print(json.dumps({"errors": out["errors"],
                      "launches": out["launches"]}))
    return out


if __name__ == "__main__":
    main()
