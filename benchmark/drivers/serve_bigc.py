"""Serving BIG-C: ``train/steps.build_infer_step(model, topk)``, the forward
in eval mode (role attention on its CUDA kernel) then ``construct_triplets``;
a request is one batch, from the step call until its triplets are on the
host.  The inputs are a pool of distinct batches drawn on the device and
cycled, as the device record cache serves every epoch after the first.
"""
from __future__ import annotations

import torch

from benchmark.checks import triplets
from benchmark.checks.sample import worst
from benchmark.counts.bigc_v10_exp2 import forward_flops
from benchmark.counts.kernels import role_attention_bound
from benchmark.harness import draws
from benchmark.harness.runtime import end_phase
from benchmark.harness.trace import no_span
from benchmark.harness.tracklets import tracklet_batch
from benchmark.reference import bigc_v10_exp2 as ref
from vidsgg_big_tpu_torch.data.types import TrackletBatch
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.ops.role_attn import role_attention
from vidsgg_big_tpu_torch.train.steps import build_infer_step


def build_model(m: dict, seed: int, device):
    """The port's model with the benchmark's weights (drawn from ``seed``),
    and those weights as a state dict."""
    with torch.device(device):
        model = BigC(BigCConfig.from_dict(m))
    end_phase("model")
    weights = draws.draw_state(model.state_dict(), seed, device)
    model.load_state_dict(weights, strict=True)
    end_phase("weights")
    return model, weights


def pool(traffic: dict, m: dict, seed: int, device) -> list:
    return [tracklet_batch(traffic, m, draws.generator(
        seed, draws.INPUTS, device, k), device)
        for k in range(traffic["pool"])]


class Work:
    kind = "serve"
    dtype = "float32"
    mark = staticmethod(no_span)

    def __init__(self, cell, seed: int, device):
        m, tr = cell.config["model_config"], cell.traffic
        self.m, self.traffic, self.topk = m, tr, tr["topk"]
        model, self.weights = build_model(m, seed, device)
        self.inputs = pool(tr, m, seed, device)
        end_phase("pool")
        self.batches = [TrackletBatch(**x) for x in self.inputs]
        self.infer = build_infer_step(model, topk=self.topk)
        self.videos_per_step = tr["batch"]
        self.flops_per_step = forward_flops(m, tr["batch"], tr["slots"],
                                            tr["frames"])
        self.kernel_bounds = {"role_attention": role_attention_bound(
            tr["batch"], m["num_querys"], tr["slots"], m["dim_att"] // 2,
            m["dim_enti"])}
        self.step(0)
        end_phase("first_request")
        for i in range(1, 2 * len(self.batches)):
            self.step(i)
        end_phase("warm")
        role_attention.launches = 0

    def step(self, i: int) -> dict:
        trip = self.infer(self.batches[i % len(self.batches)])
        with self.mark("d2h"):
            trip = trip.numpy()
        return {f: getattr(trip, f) for f in
                ("quintuples", "scores", "dura_inters", "query_ids",
                 "valid")}

    def counters(self) -> dict:
        return {"role_attention.launches": role_attention.launches}

    def release(self):
        self.infer = self.batches = None

    def _worst(self, sample, judge) -> dict:
        return worst(sample, len(self.inputs), lambda k: ref.forward(
            self.weights, self.m, self.inputs[k]), lambda k, fwd, trip:
            judge(self.weights, self.m, self.inputs[k], fwd, trip, self.topk))

    def check(self, sample) -> list:
        got = self._worst(sample, triplets.judge)
        limits = self.traffic["limits"]
        return [(n, got[n], limits[n]) for n in limits]

    def controls(self, sample, dtype) -> dict:
        return {"control": self._worst(sample, lambda *a: triplets.control(
            *a, dtype))}


def build(cell, seed: int, device):
    return Work(cell, seed, device)
