"""Training BIG-C: ``train/steps.build_train_step``: the forward with
dropout 0.1 (role attention on its plain version, as in training), vIoU
alignment, Hungarian matching on the host, the losses, backward, clip and
Adam, dispatched back to back on a pool of distinct batches on the device
(``harness/train_work.py``).
"""
from __future__ import annotations

import torch

from benchmark.counts.bigc_v10_exp2 import train_step_flops
from benchmark.harness import draws
from benchmark.harness.runtime import end_phase
from benchmark.harness.tracklets import train_batch
from benchmark.harness.train_work import TrainWork
from benchmark.reference import bigc_v10_exp2 as ref
from benchmark.reference.dropout import StepDropout
from vidsgg_big_tpu_torch.data.types import GraphBatch, TrackletBatch
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.train.steps import build_train_step


class Work(TrainWork):
    def __init__(self, cell, seed: int, device):
        m, tr = cell.config["model_config"], cell.traffic
        with torch.device(device):
            model = BigC(BigCConfig.from_dict(m))
        end_phase("model")
        self.inputs = []
        for k in range(tr["pool"]):
            props, gts = train_batch(tr, m, draws.generator(
                seed, draws.INPUTS, device, k), device)
            self.inputs.append({"props": props, "gts": gts})
        end_phase("pool")
        self.args = [(TrackletBatch(**x["props"]), GraphBatch(**x["gts"]))
                     for x in self.inputs]
        self.videos_per_step = tr["batch"]
        self.flops_per_step = train_step_flops(m, tr["batch"], tr["slots"],
                                               tr["frames"])
        self.kernel_bounds = {}
        super().__init__(cell, seed, device, model)

    def build_step(self, model, state):
        return build_train_step(model, state, t_abs=self.traffic["t_abs"])

    def dispatch(self, i: int):
        props, gts = self.args[i % len(self.args)]
        return self.train(props, gts, generator=self.generator(i))["total"]

    @staticmethod
    def low_precision(batch, dtype):
        props = batch["props"]
        return dict(batch, props=dict(props, feats=props["feats"].to(dtype)))

    def reference_loss(self, w, batch, generator):
        return ref.train_loss(w, self.m, batch, StepDropout(generator),
                              self.traffic["video_len"])

    def counters(self) -> dict:
        return {}


def build(cell, seed: int, device):
    return Work(cell, seed, device)
