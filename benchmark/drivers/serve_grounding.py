"""Serving the grounding model (stage B of VidOR):
``train/grounding_steps.build_grounding_infer_step`` with the config's
thresholds, the forward in eval mode (the combined encoder's attention on
the composed inference kernel) then ``grounding_decode``; a request is one
batch, from the step call until its outputs are on the host.  The inputs
are a pool of distinct batches drawn on the device and cycled.
"""
from __future__ import annotations

import torch

from benchmark.checks import grounding as check
from benchmark.checks.sample import worst
from benchmark.counts.grounding_vidor import forward_flops
from benchmark.counts.kernels import composed_forward_bound
from benchmark.harness import draws
from benchmark.harness.grounding import query_batch
from benchmark.harness.runtime import end_phase
from benchmark.harness.trace import no_span
from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                   GroundingModel,
                                                   composed_encoders)
from vidsgg_big_tpu_torch.ops.composed_attn import composed_attention
from vidsgg_big_tpu_torch.ops.dwsep_conv import dwsep_conv
from vidsgg_big_tpu_torch.train.grounding_steps import \
    build_grounding_infer_step

ARGS = ("video_feats", "clip_mask", "n_clips", "query_cats", "temporal",
        "query_mask")


def build_model(m: dict, seed: int, device):
    with torch.device(device):
        model = GroundingModel(GroundingConfig.from_dict(m))
    end_phase("model")
    weights = draws.draw_state(model.state_dict(), seed, device)
    model.load_state_dict(weights, strict=True)
    end_phase("weights")
    return model, weights


class Work:
    kind = "serve"
    dtype = "float32"
    mark = staticmethod(no_span)

    def __init__(self, cell, seed: int, device):
        m, tr = cell.config["model_config"], cell.traffic
        self.m, self.traffic = m, tr
        self.thresholds = {k: cell.config["inference_config"][k] for k in
                           ("score_th", "tiou_th", "bins_th", "nms_th")}
        model, self.weights = build_model(m, seed, device)
        self.inputs = [query_batch(tr, m, draws.generator(
            seed, draws.INPUTS, device, k), device)
            for k in range(tr["pool"])]
        end_phase("pool")
        self.infer = build_grounding_infer_step(model, **self.thresholds)
        b, q, t = tr["batch"], tr["queries"], tr["clips"]
        self.videos_per_step = b
        self.flops_per_step = forward_flops(m, b, q, t)
        cfg = model.cfg
        self.kernel_bounds = {}
        if "combined_encoder" in composed_encoders(cfg, b, q, t):
            self.kernel_bounds["composed_fwd"] = composed_forward_bound(
                b * q, 8, t, cfg.dim_hidden)
        self.step(0)
        end_phase("first_request")
        for i in range(1, 2 * len(self.inputs)):
            self.step(i)
        end_phase("warm")
        composed_attention.launches = 0
        dwsep_conv.launches = 0

    def step(self, i: int):
        x = self.inputs[i % len(self.inputs)]
        out = self.infer(*(x[a] for a in ARGS))
        with self.mark("d2h"):
            return [t.cpu() for t in out]

    def counters(self) -> dict:
        return {"composed_attention.launches": composed_attention.launches,
                "dwsep_conv.launches": dwsep_conv.launches}

    def release(self):
        self.infer = None

    def _worst(self, sample, judge) -> dict:
        return worst(sample, len(self.inputs),
                     lambda k: check.reference_outputs(
                         self.weights, self.m, self.inputs[k],
                         self.thresholds), judge)

    def check(self, sample) -> list:
        got = self._worst(sample, lambda k, expected, served:
                          check.judge(served, expected))
        limits = self.traffic["limits"]
        return [(n, got[n], limits[n]) for n in limits]

    def controls(self, sample, dtype) -> dict:
        return {"control": self._worst(
            sample, lambda k, expected, served: check.control(
                self.weights, self.m, self.inputs[k], self.thresholds,
                expected, dtype))}


def build(cell, seed: int, device):
    return Work(cell, seed, device)
