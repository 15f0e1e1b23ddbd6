"""The tensor-parallel parameter plan (Megatron style) over a mesh's model
axis.

Port of the JAX package's ``parallel/sharding.py`` (``mesh_from_spec`` :34,
``_spec`` :54-80, ``param_partition_specs`` :83, ``_fits`` :94,
``shard_params`` :108-119), over the port's reference torch names:

  * each two-layer MLP is column-parallel then row-parallel: the first
    ``nn.Linear``'s output features (``<mlp>.0``) and the second's input
    features (``<mlp>.2``) split over the model ranks;
  * a ``self_attn`` splits its heads: the rows of each of the q, k and v
    blocks of the packed ``in_proj_weight`` (3D, D) and ``in_proj_bias``,
    and the input features of ``out_proj.weight``;
  * the transformer FFN pairs, ``linear1``/``linear2`` and the decoder's
    ``fc2.0``/``fc2.3``, follow the column/row pattern;
  * everything else, and every axis the model extent does not divide, is
    replicated.

The layers read their shards through ``models/layers.py``'s
tensor-parallel paths; :func:`full_state_dict` gathers the shards into the
reference-named ``state_dict`` a checkpoint holds under any mesh, and
:func:`shard_state_dict` cuts one for loading.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import (MLP, MultiHeadAttention, RoleAttnDecoderLayer,
                             TransformerEncoderLayer)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter split over the model ranks along ``dim``: the axis is
    ``blocks`` equal blocks (3 for the packed q/k/v), each cut in the model
    extent's parts; ``units`` is the count that extent must divide (the
    heads of an attention; 0: the block's length)."""
    dim: int
    blocks: int = 1
    units: int = 0


def mesh_from_spec(spec: str) -> tuple:
    """The CLI's ``--mesh``: ``"8"`` -> (8, 1), 8 data ranks; ``"4,2"`` ->
    (4, 2), tensor parallelism over 2 model ranks."""
    try:
        parts = [int(p) for p in str(spec).split(",") if p.strip()]
    except ValueError:
        parts = []
    if not 1 <= len(parts) <= 2 or min(parts) < 1:
        raise ValueError(f"--mesh wants 'D' or 'D,M', got {spec!r}")
    return parts[0], (parts[1] if len(parts) == 2 else 1)


def param_partition_specs(model: nn.Module) -> dict:
    """{parameter name: :class:`Shard` or None (replicated)} for every
    parameter of ``model`` (BigC, BaseC, or any model of the shared
    layers), JAX's ``_spec`` rules."""
    specs = {name: None for name, _ in model.named_parameters()}

    def col(prefix):
        specs[prefix + ".weight"] = Shard(0)
        specs[prefix + ".bias"] = Shard(0)

    def row(prefix):
        specs[prefix + ".weight"] = Shard(1)

    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, MultiHeadAttention) and \
                name.rsplit(".", 1)[-1] == "self_attn":
            h = mod.num_heads
            specs[pre + "in_proj_weight"] = Shard(0, 3, h)
            specs[pre + "in_proj_bias"] = Shard(0, 3, h)
            specs[pre + "out_proj.weight"] = Shard(1, 1, h)
        elif isinstance(mod, TransformerEncoderLayer):
            col(pre + "linear1")
            row(pre + "linear2")
        elif isinstance(mod, RoleAttnDecoderLayer):
            col(pre + "fc2.0")
            row(pre + "fc2.3")
        elif isinstance(mod, MLP):
            ids = [i for i, m in enumerate(mod) if isinstance(m, nn.Linear)]
            if len(ids) >= 2:
                col(pre + str(ids[0]))
                row(pre + str(ids[1]))
    return specs


def _fits(shape, spec: Shard, n_model: int) -> bool:
    """Whether the model extent divides the split axis (JAX ``_fits``)."""
    length = shape[spec.dim]
    if length % spec.blocks:
        return False
    return (spec.units or length // spec.blocks) % n_model == 0


def tp_plan(model: nn.Module, n_model: int) -> dict:
    """{name: :class:`Shard`} of the parameters split over ``n_model``
    ranks: the specs whose axis the extent divides (none at 1)."""
    if n_model == 1:
        return {}
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return {n: s for n, s in param_partition_specs(model).items()
            if s is not None and _fits(shapes[n], s, n_model)}


def shard_tensor(full, spec: Shard, n: int, i: int):
    """Part ``i`` of ``n`` of ``full`` under ``spec`` (a contiguous copy)."""
    d = spec.dim
    per = full.shape[d] // (spec.blocks * n)
    x = full.unflatten(d, (spec.blocks, n, per)).select(d + 1, i)
    return x.flatten(d, d + 1).contiguous()


def gather_tensor(local, spec: Shard, axis):
    """The whole tensor from every model rank's part (``axis`` a
    ``mesh.ModelAxis``): the inverse of :func:`shard_tensor`."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(axis.size)]
    dist.all_gather(parts, local, group=axis.group)
    d = spec.dim
    x = torch.stack([p.unflatten(d, (spec.blocks, -1)) for p in parts],
                    dim=d + 1)
    return x.flatten(d, d + 2)


def _sharded_modules(model: nn.Module, plan: dict):
    """The layers whose parameters ``plan`` splits: they run their
    tensor-parallel paths."""
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        key = {MultiHeadAttention: "in_proj_weight",
               TransformerEncoderLayer: "linear1.weight",
               RoleAttnDecoderLayer: "fc2.0.weight",
               MLP: "0.weight"}.get(type(mod))
        if key is not None and pre + key in plan:
            yield mod


def shard_params(model: nn.Module, mesh) -> dict:
    """Cut ``model``'s parameters to this rank's parts of the plan (JAX
    ``shard_params``), in place, and switch the split layers to their
    tensor-parallel paths on ``mesh``'s model axis.  Returns the plan,
    which ``model.tp_plan`` keeps.  Call before building the optimizer."""
    plan = tp_plan(model, mesh.n_model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, spec in plan.items():
            p = params[name]
            p.data = shard_tensor(p.data, spec, mesh.n_model,
                                  mesh.model_index)
    for mod in _sharded_modules(model, plan):
        mod.tp = mesh.model_axis
    model.tp_plan = plan
    return plan


def model_plan(model: nn.Module) -> dict:
    """The plan :func:`shard_params` applied to ``model`` ({} if none)."""
    return getattr(model, "tp_plan", {})


def full_state_dict(model: nn.Module, mesh=None) -> dict:
    """``model.state_dict()`` with every split parameter gathered whole:
    the reference-named state of the unsharded model, alike under any mesh
    (a collective over the model group: every rank calls it)."""
    sd = model.state_dict()
    for name, spec in model_plan(model).items():
        sd[name] = gather_tensor(sd[name], spec, mesh.model_axis)
    return sd


def shard_state_dict(sd: dict, model: nn.Module, mesh=None) -> dict:
    """A whole ``state_dict`` cut to this rank's parts of ``model``'s plan
    (the elastic load of a checkpoint written under any mesh)."""
    plan = model_plan(model)
    if not plan:
        return sd
    return {k: (shard_tensor(v, plan[k], mesh.n_model, mesh.model_index)
                if k in plan else v) for k, v in sd.items()}

