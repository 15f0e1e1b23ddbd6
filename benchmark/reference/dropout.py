"""Dropout drawn as the port draws it from a step's generator, a frozen copy
of its rule (``ops/attention.dropout_mask``), so that the reference follows
the program's train steps draw for draw: each dropout takes one draw from
the step's CPU generator to seed a generator on the tensor's device (or
uses the generator itself on its own device), keeps an element where a
uniform draw reaches ``p``, and rescales what it keeps by 1 / (1 - p)."""
from __future__ import annotations

import torch


class StepDropout:
    def __init__(self, generator: torch.Generator):
        self.g = generator

    def device_generator(self, device):
        if self.g.device.type == torch.device(device).type:
            return self.g
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.g))
        return torch.Generator(device=device).manual_seed(seed)

    def __call__(self, x, p):
        keep = torch.rand(x.shape, generator=self.device_generator(x.device),
                          device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
