"""Sharded train and inference steps of the port on the CPU against the
single process: gloo ranks in a 1-D (2 data) and a 2 x 2 (data x model)
layout.

Each layout's world is spawned once (a module fixture, one torch thread a
rank) and runs its phases of ``tools/dryrun_multichip`` at its small
widths, dropout at the models' real rates: the BIG-C and Base-C train steps
and inference in both layouts (2 x 2 splits their MLPs, FFNs and attention
heads); the grounding train step, through the composed attention's plain
twin and through the chunked stored-softmax path, and its inference in the
1-D layout (the grounding model is never split, so the model ranks of
2 x 2 would repeat it).  Each case holds one phase against the same step in
this process, at JAX's tolerances (``tests/test_parallel.py:45-52``): the
loss to rtol 1e-4, the updated parameters to rtol 1e-3, atol 1e-5, the
gradients to 1e-3 of their leaf's largest; triplet scores and grounding
outputs to 1e-5, the triplets' picks and masks exactly.  The ``_routed``
train steps are the dry run's on the card: their backward takes the one
process's max-pool picks and ReLU signs, cut to the rank's rows and
features, and their own picks and signs must be ties of those.
"""
import functools

import numpy as np
import pytest

from vidsgg_big_tpu_torch.parallel.mesh import run_ranks
from vidsgg_big_tpu_torch.tools import dryrun_multichip as dm

PHASES = {**dm.PHASES, "basec_train": dm.basec_train,
          "basec_infer": dm.basec_infer,
          "grounding_train_chunked": functools.partial(dm.grounding_train,
                                                       fused=False)}
ROUTED = {"bigc_train_routed": "bigc_train",
          "basec_train_routed": "basec_train",
          "grounding_train_routed": "grounding_train"}
SPLIT = ("bigc_train", "bigc_infer", "basec_train", "basec_infer",
         "bigc_train_routed", "basec_train_routed")
LAYOUTS = {"2x1": ((2, 1), list(PHASES) + list(ROUTED)),
           "2x2": ((2, 2), list(SPLIT))}
CASES = [(layout, phase) for layout, (_, names) in LAYOUTS.items()
         for phase in names]


def _world(spec, mesh):
    """A rank's run of every phase (``spec``: the names and the routed
    steps' kink records); rank 0's results come back."""
    names, refs = spec
    p = dm.Problem("small", mesh.n_data)
    out = {}
    for name in names:
        if name not in ROUTED:
            out[name] = PHASES[name](p, mesh, mesh.device)
            continue
        kinks = dm.Kinks(refs[name], mesh)
        out[name] = PHASES[ROUTED[name]](p, mesh, mesh.device, kinks=kinks)
        out[name]["ties"] = kinks.ties()
    return out


@pytest.fixture(scope="module")
def worlds():
    """{layout: rank 0's results}, each world spawned at its first use."""
    return {}


def _results(worlds, layout):
    if layout not in worlds:
        (n_data, n_model), names = LAYOUTS[layout]
        refs = {name: _one_process(ROUTED[name])[1] for name in names
                if name in ROUTED}
        worlds[layout] = run_ranks(_world, (names, refs), n_data, n_model,
                                   "cpu", threads=1)
    return worlds[layout]


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """(the phase in this process, its kink record: empty but for the
    train steps of ``dm.TRAIN``)."""
    kinks = dm.Kinks()
    kw = {"kinks": kinks} if name in dm.TRAIN else {}
    return PHASES[name](dm.Problem("small", 2), None, "cpu", **kw), \
        kinks.record()


def _single(name):
    return _one_process(ROUTED.get(name, name))[0]


@pytest.mark.parametrize("layout,phase", CASES)
def test_layout_matches_the_single_process(worlds, layout, phase):
    errs = dm.compare(phase, _results(worlds, layout)[phase], _single(phase))
    assert all(np.isfinite(v) for v in errs.values()), errs


@pytest.mark.parametrize("layout,phase", [
    ("2x1", "bigc_train"), ("2x1", "basec_train"), ("2x1", "grounding_train"),
    ("2x2", "bigc_train"), ("2x2", "basec_train")])
def test_gradients_reduce_once_per_step(worlds, layout, phase):
    """One coalesced all-reduce of every gradient of the rank's part: the
    whole model's in 2 x 1, less under 2 x 2 where the plan splits BIG-C's
    and Base-C's MLPs."""
    full = sum(v.size * v.itemsize for k, v in
               _single(phase)["params"].items() if k in _trainable(phase))
    got = _results(worlds, layout)[phase]["sync_bytes"]
    if layout == "2x2":
        assert 0 < got < full
    else:
        assert got == full


@functools.lru_cache(maxsize=None)
def _trainable(phase):
    p = dm.Problem("small", 2)
    model = {"bigc_train": dm.bigc_model, "basec_train": dm.basec_model,
             "grounding_train": dm.grounding_model}[phase](p)
    return {n for n, t in model.named_parameters() if t.requires_grad}


@pytest.mark.parametrize("kind", ["relu", "pool"])
def test_kink_routing_takes_the_reference_backward(kind):
    """Routed by its own record, a step is the unrouted one; a record whose
    kink of ``kind`` is moved off its tie (its largest input negated, or
    lowered below every other) is caught by the tie check."""
    single, record = _one_process("bigc_train")
    p = dm.Problem("small", 2)
    kinks = dm.Kinks(record)
    same = dm.bigc_train(p, None, "cpu", kinks=kinks)
    same["ties"] = kinks.ties()
    errs = dm.compare("bigc_train", same, single)
    assert errs["kink_flips"] == 0 and errs["grads"] == 0.0, errs
    i, (_, x, args) = next((i, r) for i, r in enumerate(record)
                           if r[0] == kind)
    moved = x.clone().reshape(-1)
    j = int(moved.argmax())
    moved[j] = -moved[j] if kind == "relu" else moved.min() - 1
    bad = list(record)
    bad[i] = (kind, moved.reshape(x.shape), args)
    kinks = dm.Kinks(bad)
    wrong = dm.bigc_train(p, None, "cpu", kinks=kinks)
    wrong["ties"] = kinks.ties()
    assert wrong["ties"][i][1] >= 1
    with pytest.raises(AssertionError):
        dm.compare("bigc_train", wrong, single)
