"""Checkpoints and the stop latch of a sharded run of the port on the CPU
(four gloo ranks, one world for the module).

Elastic resume, as the JAX test ``tests/test_parallel.py:117-190``: a BIG-C
state trained one step under a 2 x 2 (data x model) mesh is checkpointed;
the same ranks then lay out a 4 x 1 and a 1 x 4 mesh, restore it there,
write it again and train a step.  The checkpoint is the same file under
every mesh and in one process, it restores equal everywhere, and the step
after it matches the single process's.  The stop latch: a stop requested on
one rank alone stops every rank after the same step, with one checkpoint.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vidsgg_big_tpu_torch.parallel.mesh import make_mesh, run_ranks, shard_rows
from vidsgg_big_tpu_torch.parallel.sharding import shard_params, tp_plan
from vidsgg_big_tpu_torch.tools import dryrun_multichip as dm
from vidsgg_big_tpu_torch.train.loop import run_epochs
from vidsgg_big_tpu_torch.train.steps import build_train_step
from vidsgg_big_tpu_torch.train.train_state import (
    TrainState, checkpoint_steps, load_checkpoint, load_checkpoint_position,
    save_checkpoint)
from vidsgg_big_tpu_torch.utils.logger import NullWriter, quiet_logger

PROBLEM = dm.Problem("small", 2)         # 4 videos
LAYOUTS = ("4x1", "1x4")


def _state(mesh=None):
    model = dm.bigc_model(PROBLEM)
    if mesh is not None:
        shard_params(model, mesh)
    return TrainState(model, 1e-4, 0.2, [1000], mesh=mesh)


def _step(state, mesh=None):
    props, gts = PROBLEM.tracklet_batch(PROBLEM.bigc_cfg())
    if mesh is not None:
        props, gts = shard_rows((props, gts), mesh)
    step = build_train_step(state.model, state, t_abs=64)
    return float(step(props, gts, generator=torch.Generator().manual_seed(
        state.step))["total"])


def _world(root, mesh):
    first = _state(mesh)
    out = {"loss_2x2": _step(first, mesh)}
    save_checkpoint(os.path.join(root, "2x2"), first, 1, epoch=1)
    for layout in LAYOUTS:
        d, m = map(int, layout.split("x"))
        sub = make_mesh(d, m, mesh.device)
        state = _state(sub)
        load_checkpoint(os.path.join(root, "2x2"), state)
        save_checkpoint(os.path.join(root, layout), state, state.step,
                        epoch=1)
        out[layout] = (state.step, _step(state, sub), state.step,
                       len(state.plan))
    # the stop latch: rank 1 alone asks to stop once two steps are done
    latch = make_mesh(4, 1, mesh.device)
    state = _state(latch)
    batch = shard_rows(PROBLEM.tracklet_batch(PROBLEM.bigc_cfg()), latch)
    step = build_train_step(state.model, state, t_abs=64)
    run_epochs(state, lambda b, g: step(*b, generator=g),
               lambda epoch, skip: [batch] * (5 - skip), start_epoch=0,
               total_epoch=1, base_seed=1, writer=NullWriter(),
               logger=quiet_logger(), ckpt_dir=os.path.join(root, "latch"),
               ckpt_every=1, should_stop=lambda: (
                   latch.rank == 1 and state.step >= 2))
    steps = [None] * latch.world
    dist.all_gather_object(steps, state.step, group=latch.host_group)
    out["latch_steps"] = steps
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    return root, run_ranks(_world, root, 2, 2, "cpu", threads=1)


def _file(root, layout):
    with open(os.path.join(root, layout, "ckpt_1.pt"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_is_the_same_file_under_any_mesh(world, layout):
    root, _ = world
    assert _file(root, layout) == _file(root, "2x2")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_restores_and_trains_under_another_mesh(world, layout):
    """Restored at step 1 (the elastic load cuts the whole state: 1 x 4
    splits the heads four ways), a step there agrees with the single
    process's step from the same checkpoint."""
    root, out = world
    before, loss, after, n_split = out[layout]
    assert (before, after) == (1, 2)
    n_model = int(layout.split("x")[1])
    assert n_split == len(tp_plan(dm.bigc_model(PROBLEM), n_model))
    assert (n_split > 0) == (n_model > 1)
    single = _state()
    load_checkpoint(os.path.join(root, "2x2"), single)
    np.testing.assert_allclose(loss, _step(single), rtol=1e-4)


def test_checkpoint_restores_in_one_process(world, tmp_path):
    """The 2 x 2 checkpoint loads into an unsharded state equal to the
    file, which writes it back byte for byte."""
    root, out = world
    sd = torch.load(os.path.join(root, "2x2", "ckpt_1.pt"),
                    weights_only=True)
    state = _state()
    assert load_checkpoint(os.path.join(root, "2x2"), state) == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, sd["model"][k]), k
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sd["optimizer"]["state"][i][k]), (i, k)
    save_checkpoint(str(tmp_path), state, 1, epoch=1)
    assert _file(str(tmp_path.parent), tmp_path.name) == _file(root, "2x2")
    # the 2 x 2 step itself matched the single process's first step
    np.testing.assert_allclose(out["loss_2x2"], _step(_state()), rtol=1e-4)


def test_a_stop_on_one_rank_stops_every_rank_at_the_same_step(world):
    root, out = world
    assert out["latch_steps"] == [2, 2, 2, 2]
    latch = os.path.join(root, "latch")
    assert checkpoint_steps(latch) == [2]
    assert load_checkpoint_position(latch, 2) == (0, 2)
    with open(os.path.join(latch, "meta_2.json")) as f:
        assert json.load(f)["batch_in_epoch"] == 2
