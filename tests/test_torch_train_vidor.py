"""The port's grounding trainer entry point on the CPU.

``python -m vidsgg_big_tpu_torch.tools.train_vidor --train_grounding`` on the
demo grounding config with a few synthetic videos: it trains and journals;
a run stopped at a step boundary and resumed from its checkpoint ends with
parameters bit-equal to an uninterrupted run, dropout on; the epoch order
and the grounding self-evaluation equal the JAX package's.
"""
import json
import os

import numpy as np
import pytest
import torch

from vidsgg_big_tpu.data import bucketing as jax_bucketing
from vidsgg_big_tpu.evaluation import grounding_eval as jax_grounding_eval

from vidsgg_big_tpu_torch.data.bucketing import iter_shuffled
from vidsgg_big_tpu_torch.evaluation import grounding_eval
from vidsgg_big_tpu_torch.tools import train_vidor
from vidsgg_big_tpu_torch.train.train_state import checkpoint_steps

CFG = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo",
                   "config_grounding_.py")
# 5 videos in batches of 2 (the last padded by a masked repeat): 3 steps
# per epoch
BASE = ["--train_grounding", "--cfg_path", CFG, "--synthetic", "5",
        "--device", "cpu", "--epochs", "2"]


def _losses(out_dir):
    with open(os.path.join(out_dir, "logfile", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "loss/total"}


def _final_state(out_dir):
    d = os.path.join(out_dir, "checkpoints_grd_torch")
    step = checkpoint_steps(d)[-1]
    return step, torch.load(os.path.join(d, f"ckpt_{step}.pt"),
                            weights_only=True)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("full"))
    summary = train_vidor.main(BASE + ["--output_dir", out, "--ckpt_every",
                                       "1"])
    return out, summary


def test_trains_and_writes_metrics_and_checkpoints(full_run):
    out, summary = full_run
    assert summary["step"] == 6
    losses = _losses(out)
    assert sorted(losses) == list(range(1, 7))
    assert all(np.isfinite(v) for v in losses.values())
    ckpt = os.path.join(out, "checkpoints_grd_torch")
    assert checkpoint_steps(ckpt) == [3, 6]
    with open(os.path.join(ckpt, "meta_6.json")) as f:
        assert json.load(f) == {"step": 6, "epoch": 2, "batch_in_epoch": 0}
    step, sd = _final_state(out)
    assert step == 6 and sd["step"] == 6
    assert set(sd) == {"step", "model", "optimizer"}


def test_stop_and_resume_is_bit_equal(full_run, tmp_path):
    """Stopped after 4 batches (mid-epoch 1, as on SIGTERM) and resumed:
    the same per-step losses and bit-equal final parameters and optimizer
    state as the uninterrupted run (dropout 0.1 on, every step's draws a
    function of (seed, step))."""
    out_full, _ = full_run
    out = str(tmp_path)
    stopped = train_vidor.main(BASE + ["--output_dir", out,
                                       "--stop_after_batches", "4"])
    assert stopped["step"] == 4
    with open(os.path.join(out, "checkpoints_grd_torch",
                           "meta_4.json")) as f:
        assert json.load(f) == {"step": 4, "epoch": 1, "batch_in_epoch": 1}
    resumed = train_vidor.main(BASE + ["--output_dir", out,
                                       "--from_checkpoint"])
    assert resumed["step"] == 6
    assert _losses(out) == _losses(out_full)
    (s1, a), (s2, b) = _final_state(out_full), _final_state(out)
    assert s1 == s2 == 6
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, st in a["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][k][name]), (k, name)


def test_ckpt_every_defaults_to_the_reference_cadence():
    """A checkpoint every 10 epochs, as the JAX trainer's default."""
    assert train_vidor.parse_args(["--cfg_path", CFG]).ckpt_every == 10


def test_left_out_modes_raise():
    with pytest.raises(NotImplementedError, match="A7b"):
        train_vidor.main(BASE + ["--train_baseline"])
    with pytest.raises(NotImplementedError, match="A9"):
        train_vidor.main(BASE + ["--mesh", "1,1"])
    with pytest.raises(NotImplementedError, match="pass --train_grounding"):
        train_vidor.main(BASE[1:])


def test_iter_shuffled_order_matches_jax():
    data = list(range(17))
    for seed in (0, 1, 5):
        assert list(iter_shuffled(data, seed=seed)) == list(
            jax_bucketing.iter_shuffled(data, seed=seed))


def test_grounding_eval_matches_jax():
    rng = np.random.default_rng(0)
    u, k1 = 6, 5
    s = rng.uniform(0, 0.7, (u, k1, 1))
    spans = np.concatenate([s, s + rng.uniform(0.05, 0.3, (u, k1, 1))], -1)
    mask = rng.random((u, k1)) < 0.5
    mask[2] = False
    t = rng.uniform(0, 0.7, (9, 1))
    targets = np.concatenate([t, t + rng.uniform(0.05, 0.3, (9, 1))], -1)
    groups = [np.array([0, 1]), np.array([2]), np.array([3, 4, 5]),
              np.array([6]), np.array([7]), np.array([8])]
    np.testing.assert_array_equal(
        grounding_eval.grounding_tiou(spans, mask, targets, groups),
        jax_grounding_eval.grounding_tiou(spans, mask, targets, groups))
    assert grounding_eval.grounding_f1(
        spans, mask, targets, groups, tiou_ths=(0.3, 0.5, 0.7)) == \
        jax_grounding_eval.grounding_f1(spans, mask, targets, groups,
                                        tiou_ths=(0.3, 0.5, 0.7))
