"""Serving BIG-C in bfloat16: ``serve_bigc`` with the traffic's
``compute_dtype`` merged into the model configuration, as ``eval_vidvrd
--compute_dtype`` does, and the pool's features stored in the traffic's
``feat_dtype`` on the card (``eval_vidvrd --feat_dtype``).  The port then
runs the encoder's per-frame products and ``fc_i3d`` in bfloat16 and the
rest, role attention's kernel included, in float32
(``counts/bigc_v10_exp2_bf16.py``).

The check is ``serve_bigc``'s, against the reference at the precision
the cell states (``checks/fp8.stated``: those products in bfloat16, the
rest in float32) on the features as stored; the control rounds the
operands of the bfloat16 products through float8 e4m3, and the whole
reference in bfloat16 stands for a program that runs its float32 parts in
bfloat16 (``checks/fp8.py``).
"""
from __future__ import annotations

import torch

from benchmark.checks import fp8, triplets
from benchmark.checks.sample import worst
from benchmark.counts.bigc_v10_exp2_bf16 import forward_flops_by_dtype
from benchmark.counts.kernels import role_attention_bound
from benchmark.drivers import serve_bigc
from benchmark.harness import draws
from benchmark.harness.runtime import end_phase
from benchmark.harness.tracklets import tracklet_batch
from benchmark.reference import bigc_v10_exp2 as ref
from vidsgg_big_tpu_torch.data.types import TrackletBatch
from vidsgg_big_tpu_torch.ops.role_attn import role_attention
from vidsgg_big_tpu_torch.train.steps import build_infer_step


class Work(serve_bigc.Work):
    control_dtype = fp8.FP8

    def __init__(self, cell, seed: int, device):
        tr = cell.traffic
        m = dict(cell.config["model_config"],
                 compute_dtype=tr["compute_dtype"])
        self.m, self.traffic, self.topk = m, tr, tr["topk"]
        self.dtype = tr["compute_dtype"]
        model, self.weights = serve_bigc.build_model(m, seed, device)
        if model.compute_dtype != getattr(torch, self.dtype):
            raise RuntimeError(f"the model computes in {model.compute_dtype}"
                               f", not the traffic's {self.dtype}")
        feat_dtype = getattr(torch, tr["feat_dtype"])
        self.inputs = []
        for k in range(tr["pool"]):
            x = tracklet_batch(tr, m, draws.generator(
                seed, draws.INPUTS, device, k), device)
            x["feats"] = x["feats"].to(feat_dtype)
            self.inputs.append(x)
        end_phase("pool")
        self.batches = [TrackletBatch(**x) for x in self.inputs]
        self.infer = build_infer_step(model, topk=self.topk)
        self.videos_per_step = tr["batch"]
        self.flops_by_dtype = forward_flops_by_dtype(
            m, tr["batch"], tr["slots"], tr["frames"])
        self.flops_per_step = sum(self.flops_by_dtype.values())
        self.kernel_bounds = {"role_attention": role_attention_bound(
            tr["batch"], m["num_querys"], tr["slots"], m["dim_att"] // 2,
            m["dim_enti"])}
        self.step(0)
        end_phase("first_request")
        for i in range(1, 2 * len(self.batches)):
            self.step(i)
        end_phase("warm")
        role_attention.launches = 0

    def _reference_inputs(self, k: int) -> dict:
        """Pool batch ``k`` with its stored features in float32."""
        x = self.inputs[k]
        return dict(x, feats=x["feats"].float())

    def _worst(self, sample, judge) -> dict:
        """``serve_bigc``'s, with the reference and the judge at the
        stated precision."""
        def expected(k):
            with fp8.stated(self.weights):
                return ref.forward(self.weights, self.m,
                                   self._reference_inputs(k))

        def judged(k, fwd, trip):
            with fp8.stated(self.weights):
                return judge(self.weights, self.m, self.inputs[k], fwd,
                             trip, self.topk)
        return worst(sample, len(self.inputs), expected, judged)

    def controls(self, sample, dtype=fp8.FP8) -> dict:
        """The control (the bfloat16 products' operands through ``dtype``)
        and the whole reference in bfloat16; each has to read over a
        limit."""
        return {"control": self._worst(sample, lambda *a: fp8.bigc_serve(
            *a, dtype)), "reference_bf16": self._worst(
                sample, lambda *a: triplets.control(*a, torch.bfloat16))}


def build(cell, seed: int, device):
    return Work(cell, seed, device)
