"""The port's VidOR trainer entry point on the CPU.

``python -m vidsgg_big_tpu_torch.tools.train_vidor --train_grounding`` on the
demo grounding config with a few synthetic videos: it trains and journals;
a run stopped at a step boundary and resumed from its checkpoint ends with
parameters bit-equal to an uninterrupted run, dropout on; the epoch order
and the grounding self-evaluation equal the JAX package's.  The BIG-C v7
classification mode (no flag) and Base-C (``--train_baseline``) on the demo
VidOR config do the same, and their checkpoints serve through
``eval_vidor --ckpt_path``.
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
from vidsgg_big_tpu_torch.models.base_c import BaseCConfig
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.tools import eval_vidor, eval_vidvrd, train_vidor
from vidsgg_big_tpu_torch.train.train_state import checkpoint_steps
from vidsgg_big_tpu_torch.utils.config import parse_config_py

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


def _final_state(out_dir, tag="grd"):
    d = os.path.join(out_dir, f"checkpoints_{tag}_torch")
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
    """Every mode takes the multi-GPU flags now (ROADMAP A9): a malformed
    --mesh raises naming the flag, and a mesh whose data axis does not
    divide the batch raises, as the JAX CLI's assert."""
    for mode in (BASE, CLS_BASE, CLS_BASE + ["--train_baseline"]):
        with pytest.raises(ValueError, match="--mesh"):
            train_vidor.main(mode + ["--mesh", "1,2,3"])
        with pytest.raises(ValueError, match="divisible"):
            train_vidor.main(mode + ["--mesh", "2", "--batch_size", "3"])


# ---- the classification modes: BIG-C v7 (no flag) and Base-C ------------

CLS_CFG = os.path.join(os.path.dirname(__file__), "..", "experiments",
                       "demo", "config_vidor_.py")
# 10 videos in batches of 2 on the (N, T) buckets: at least 5 steps an
# epoch, so the journal reaches step 10, where the extra metrics go
CLS_BASE = ["--cfg_path", CLS_CFG, "--synthetic", "10", "--device", "cpu",
            "--epochs", "2"]
MODES = {"cls": [], "base": ["--train_baseline"]}


@pytest.fixture(scope="module", params=list(MODES))
def cls_run(request, tmp_path_factory):
    tag = request.param
    out = str(tmp_path_factory.mktemp(tag))
    summary = train_vidor.main(CLS_BASE + MODES[tag] + [
        "--output_dir", out, "--ckpt_every", "1"])
    return tag, out, summary


def test_classification_modes_train_and_journal(cls_run):
    """Each mode trains two epochs with finite losses, journals its loss
    terms and checkpoints each epoch in its own directory."""
    tag, out, summary = cls_run
    steps = summary["step"]
    assert steps >= 10 and summary["ckpt_dir"].endswith(
        f"checkpoints_{tag}_torch")
    losses = _losses(out)
    assert sorted(losses) == list(range(1, steps + 1))
    assert all(np.isfinite(v) for v in losses.values())
    assert len(checkpoint_steps(summary["ckpt_dir"])) == 2
    with open(os.path.join(out, "logfile", "metrics.jsonl")) as f:
        extra = {r["tag"]: r["value"] for r in map(json.loads, f)
                 if r["step"] == 10 and r["tag"].startswith("loss/")
                 and r["tag"] != "loss/total"}
    assert set(extra) == {f"loss/{k}" for k in
                          train_vidor.EXTRA_METRICS[tag]}
    assert all(np.isfinite(v) for v in extra.values())
    assert os.path.exists(os.path.join(out, "logfile",
                                       f"train_{tag}_torch.log"))


def test_classification_modes_stop_and_resume_bit_equal(cls_run, tmp_path):
    """Stopped after 2 batches (mid-epoch, as on SIGTERM) and resumed: the
    losses of the uninterrupted run and bit-equal final parameters and
    optimizer state (BIG-C's dropout 0.1 on)."""
    tag, out_full, summary = cls_run
    out = str(tmp_path)
    stopped = train_vidor.main(CLS_BASE + MODES[tag] + [
        "--output_dir", out, "--stop_after_batches", "2"])
    assert stopped["step"] == 2
    resumed = train_vidor.main(CLS_BASE + MODES[tag] + [
        "--output_dir", out, "--from_checkpoint"])
    assert resumed["step"] == summary["step"]
    assert _losses(out) == _losses(out_full)
    (s1, a), (s2, b) = _final_state(out_full, tag), _final_state(out, tag)
    assert s1 == s2 == summary["step"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, st in a["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][k][name]), (k, name)


def test_classification_checkpoints_serve(cls_run):
    """eval_vidor's stage-A model constructors load the newest checkpoint
    of the mode's directory: the trained weights bit for bit."""
    tag, _, summary = cls_run
    mc = parse_config_py(CLS_CFG)["model_config"]
    if tag == "base":
        model = eval_vidor.build_basec_model(BaseCConfig.from_dict(mc), mc,
                                             summary["ckpt_dir"])
    else:
        model = eval_vidvrd.build_model(BigCConfig.from_dict(
            mc, variant="v7"), mc, summary["ckpt_dir"])
    _, want = _final_state(os.path.dirname(summary["ckpt_dir"]), tag)
    for k, v in want["model"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_classification_defaults_follow_the_jax_cli():
    """p_bucket = model_config.get("max_preds", 128) (128 for exp4-6, whose
    max_preds sits in the dataset configs), t_abs 4096, and the int8 wire
    packs a scale per video."""
    for exp in ("exp4", "exp5", "exp6"):
        mc = parse_config_py(os.path.join(
            os.path.dirname(__file__), "..", "experiments", exp,
            "config_.py"))["model_config"]
        assert mc.get("max_preds", 128) == 128
    assert train_vidor.T_ABS == 4096


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
