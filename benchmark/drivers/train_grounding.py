"""Training the grounding model: ``train/grounding_steps.
build_grounding_train_step``: the queries and labels, the forward over the
positive and negative query slots at dropout 0.1 (the combined encoder's
attention on the composed train forward and backward kernels), the loss,
backward, clip and Adam, dispatched back to back on a pool of distinct
batches on the device (``harness/train_work.py``).
"""
from __future__ import annotations

import torch

from benchmark.counts.grounding_vidor import train_step_flops
from benchmark.counts.kernels import (composed_backward_bound,
                                      composed_forward_bound)
from benchmark.harness import draws
from benchmark.harness.grounding import train_batch
from benchmark.harness.runtime import end_phase
from benchmark.harness.train_work import TrainWork
from benchmark.reference import grounding_vidor as ref
from vidsgg_big_tpu_torch.data.types import GraphBatch
from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                   GroundingModel,
                                                   attention_lowering)
from vidsgg_big_tpu_torch.ops.composed_attn import (
    composed_attention_backward, composed_attention_train)
from vidsgg_big_tpu_torch.train.grounding_steps import \
    build_grounding_train_step


class Work(TrainWork):
    def __init__(self, cell, seed: int, device):
        m, tr = cell.config["model_config"], cell.traffic
        with torch.device(device):
            model = GroundingModel(GroundingConfig.from_dict(m))
        end_phase("model")
        self.inputs = [train_batch(tr, m, draws.generator(
            seed, draws.INPUTS, device, k), device)
            for k in range(tr["pool"])]
        end_phase("pool")
        self.graphs = [GraphBatch(**x["gts"]) for x in self.inputs]
        b, p, t, h = tr["batch"], tr["pred_slots"], tr["clips"], \
            m["dim_hidden"]
        rows = b * 2 * p                     # positive and negative slots
        self.videos_per_step = b
        self.flops_per_step = train_step_flops(m, b, 2 * p, t)
        self.kernel_bounds = {}
        if attention_lowering(rows, t, h, 1 << 30)[0] == "composed":
            self.kernel_bounds = {
                "composed_fwd_train": composed_forward_bound(rows, 8, t, h),
                "composed_bwd": composed_backward_bound(rows, 8, t, h)}
        super().__init__(cell, seed, device, model)
        composed_attention_train.launches = 0
        composed_attention_backward.launches = 0

    build_step = staticmethod(build_grounding_train_step)

    def dispatch(self, i: int):
        k = i % len(self.inputs)
        x = self.inputs[k]
        return self.train(x["video_feats"], x["clip_mask"], x["n_clips"],
                          self.graphs[k], x["video_len"],
                          generator=self.generator(i),
                          noise=x["noise"])["total"]

    @staticmethod
    def low_precision(batch, dtype):
        return dict(batch, video_feats=batch["video_feats"].to(dtype))

    def reference_loss(self, w, batch, generator):
        return ref.train_loss(w, self.m, batch, generator)

    def counters(self) -> dict:
        return {"composed_attention_train.launches":
                composed_attention_train.launches,
                "composed_attention_backward.launches":
                composed_attention_backward.launches}


def build(cell, seed: int, device):
    return Work(cell, seed, device)
