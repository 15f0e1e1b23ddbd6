"""Process groups, row slicing and launch for data and tensor parallelism.

Port of the JAX package's ``parallel/mesh.py`` and of the mesh half of its
``parallel/sharding.py`` (``make_mesh_2d``, :46).  JAX lays out a 1-D
``data`` or a 2-D ``(data, model)`` device mesh and GSPMD derives the
collectives; here one process drives one card (a rank), the mesh is a D x M
grid of ranks in the same row-major order (rank r is data index r // M and
model index r % M), and the collectives are written out:

* a packed batch is cut over the data axis (:func:`shard_rows`, JAX's
  ``shard_batch``) and outputs come back to every data rank
  (:func:`gather_rows`);
* losses divide by counts summed over the data group (:func:`data_sum`) and
  gradients are summed over it after backward (``train/train_state.py``);
* tensor-parallel layers (``models/layers.py``) reduce over the model group
  through Megatron's pair :func:`copy_to_model` / :func:`reduce_from_model`.

NCCL is the backend on the card and gloo on the CPU; a gloo group over every
rank agrees on host-side decisions (the stop latch, ``train/loop.py``).
:func:`run_ranks` starts an entry point's ranks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import signal
import tempfile
import threading

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..data.transfer import tree_map
from ..ops.attention import ShardedDraws


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model (tensor-parallel) axis as a layer sees it: its process
    group, its extent and this rank's index on it."""
    group: object
    size: int
    index: int


@dataclasses.dataclass
class Mesh:
    """This rank's place in a D x M grid of ranks: ``data_group`` holds the
    D ranks of its model index, ``model_group`` the M ranks of its data
    index, ``host_group`` every rank (gloo)."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: object
    model_group: object
    host_group: object

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes logs, metrics, checkpoints and results."""
        return self.rank == 0

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model_group, self.n_model, self.model_index)

    def draws(self, generator) -> ShardedDraws:
        """``generator`` with this rank's share of every draw from it."""
        return ShardedDraws(generator, rows=(self.data_index, self.n_data),
                            features=(self.model_index, self.n_model))

    def __repr__(self):
        return (f"Mesh({self.n_data} data x {self.n_model} model, rank "
                f"{self.rank}, {self.device})")


def make_mesh(n_data: int, n_model: int = 1, device="cpu") -> Mesh:
    """The D x M grid over the initialized process group, whose size must
    be ``n_data * n_model``.  Every rank builds every sub-group, in one
    order; several meshes may be made over one group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the process group has "
                         f"{world}")
    data = model = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model = g
    host = (dist.group.WORLD if dist.get_backend() == "gloo" else
            dist.new_group(list(range(world)), backend="gloo"))
    return Mesh(n_data, n_model, rank, torch.device(device), data, model,
                host)


def init_mesh(n_data: int, n_model: int = 1, device="cuda", *,
              backend=None, init_method: str = "env://", rank=None,
              world_size=None, shared_device: bool = False) -> Mesh:
    """Join (or start) the process group and return this rank's mesh.

    On the card a rank drives ``cuda:LOCAL_RANK`` (its rank where the
    environment names none), or ``cuda:0`` with ``shared_device`` (several
    gloo ranks on one card); it raises if that card is absent.  The backend
    is NCCL on the card and gloo on the CPU unless ``backend`` says."""
    device = torch.device(device)
    if not dist.is_initialized():
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method, **kw)
    rank = dist.get_rank()
    if device.type == "cuda":
        local = 0 if shared_device else int(os.environ.get("LOCAL_RANK",
                                                           rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: cuda:{local} is absent ("
                               f"{torch.cuda.device_count()} cards visible)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    return make_mesh(n_data, n_model, device)


def destroy_mesh() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- collectives ----------------------------------------------------------

def data_sum(x, mesh):
    """``x`` summed over the data group (a copy; ``x`` itself where
    ``mesh`` is None): the global count behind a loss's mean."""
    if mesh is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.data_group)
    return y


def shard_rows(tree, mesh):
    """This rank's rows of every leaf's leading axis (JAX ``shard_batch``):
    the data index's share of B / D rows; B must divide by D."""
    def cut(x):
        b = x.shape[0]
        if b % mesh.n_data:
            raise ValueError(f"a leading axis of {b} rows does not divide "
                             f"over {mesh.n_data} data ranks")
        n = b // mesh.n_data
        return x[mesh.data_index * n:(mesh.data_index + 1) * n]
    return tree_map(cut, tree)


def gather_rows(tree, mesh):
    """Every data rank's rows of each leaf, concatenated in data order on
    every rank of the data group (the inverse of :func:`shard_rows`)."""
    def gather(x):
        y = x.contiguous()
        y = y.to(torch.uint8) if x.dtype == torch.bool else y
        parts = [torch.empty_like(y) for _ in range(mesh.n_data)]
        dist.all_gather(parts, y, group=mesh.data_group)
        out = torch.cat(parts)
        return out.bool() if x.dtype == torch.bool else out
    return tree_map(gather, tree)


def agree_any(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank (a MAX over the host group: a
    host-side decision every rank then takes alike)."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the model
    group backward (before a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: partial sums added over the model group forward,
    identity backward (after a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, axis):
    """``x`` entering a column-parallel layer on ``axis`` (a
    :class:`ModelAxis`, or None for an unsharded layer)."""
    if axis is None or axis.size == 1:
        return x
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x, axis):
    """A row-parallel layer's partial output summed over ``axis``."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModel.apply(x, axis.group)


# ---- launch ---------------------------------------------------------------

def _rank_main(rank, fn, args, n_data, n_model, device, backend, init,
               result, shared_device, threads):
    if not shared_device:
        os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(threads)
    mesh = init_mesh(n_data, n_model, device, backend=backend,
                     init_method=init, rank=rank,
                     world_size=n_data * n_model,
                     shared_device=shared_device)
    try:
        out = fn(args, mesh)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        destroy_mesh()


def run_ranks(fn, args, n_data: int, n_model: int = 1, device="cuda", *,
              backend=None, shared_device: bool = False, threads=None):
    """Run ``fn(args, mesh)`` on the ranks of an ``n_data`` x ``n_model``
    mesh and return rank 0's value.

    Under ``torchrun`` (``WORLD_SIZE`` set) this process joins the group it
    set up, whose size must be the mesh's.  Otherwise one rank runs in this
    process, or more are spawned, one per card on the card (the mesh must
    cover the visible cards, unless ``shared_device`` puts every rank on
    ``cuda:0``) and on the CPU as many as the mesh has (``threads`` torch
    threads each, by default this process's threads over the ranks).  A
    SIGTERM or SIGINT here is passed on to the spawned ranks."""
    world = n_data * n_model
    dev = torch.device(device).type
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs {world} "
                             f"ranks; WORLD_SIZE is "
                             f"{os.environ['WORLD_SIZE']}")
        mesh = init_mesh(n_data, n_model, dev, backend=backend,
                         shared_device=shared_device)
        try:
            return fn(args, mesh)
        finally:
            destroy_mesh()
    if dev == "cuda" and not shared_device and \
            world != torch.cuda.device_count():
        raise ValueError(f"a {n_data} x {n_model} mesh needs {world} ranks, "
                         f"one per card; {torch.cuda.device_count()} cards "
                         "are visible")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'init')}"
        if world == 1:
            mesh = init_mesh(1, 1, dev, backend=backend, init_method=init,
                             rank=0, world_size=1,
                             shared_device=shared_device)
            try:
                return fn(args, mesh)
            finally:
                destroy_mesh()
        result = os.path.join(tmp, "result.pkl")
        threads = threads or max(1, torch.get_num_threads() // world)
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, n_data, n_model, dev, backend, init,
                              result, shared_device, threads),
            nprocs=world, join=False, start_method="spawn")

        def forward(signum, frame):
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

        main = threading.current_thread() is threading.main_thread()
        old = {s: signal.signal(s, forward)
               for s in (signal.SIGTERM, signal.SIGINT)} if main else {}
        try:
            while not ctx.join():
                pass
        finally:
            for s, h in old.items():
                signal.signal(s, h)
        with open(result, "rb") as f:
            return pickle.load(f)
