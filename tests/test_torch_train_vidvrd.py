"""The port's BIG-C trainer entry point on the CPU.

``python -m vidsgg_big_tpu_torch.tools.train_vidvrd`` on the demo BIG-C
config with a few synthetic videos: it trains and journals the loss terms
and the gradient norm; a run stopped at a step boundary and resumed from
its checkpoint gives the losses and parameters of an uninterrupted run bit
for bit, dropout on; the flags left out raise naming their ROADMAP item;
``eval_vidvrd --ckpt_path <checkpoint dir>`` serves the trained weights.
"""
import json
import os

import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.data.bucketing import BucketSpec, bucketed_batches
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.tools import eval_vidvrd, train_vidvrd
from vidsgg_big_tpu_torch.train.train_state import checkpoint_steps
from vidsgg_big_tpu_torch.utils.config import parse_config_py

CFG = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo",
                   "config_smoke_.py")
# 10 videos in batches of 2: 5 steps an epoch, 10 in all, so the journal
# reaches step 10, where the extra metrics are written
BASE = ["--cfg_path", CFG, "--synthetic", "10", "--batch_size", "2",
        "--epochs", "2", "--device", "cpu"]


def _journal(out_dir):
    with open(os.path.join(out_dir, "logfile", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(out_dir):
    return {r["step"]: r["value"] for r in _journal(out_dir)
            if r["tag"] == "loss/total"}


def _final(out_dir):
    d = os.path.join(out_dir, "checkpoints_")
    step = checkpoint_steps(d)[-1]
    return step, torch.load(os.path.join(d, f"ckpt_{step}.pt"),
                            weights_only=True)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("full"))
    summary, state = train_vidvrd.train(train_vidvrd.parse_args(
        BASE + ["--output_dir", out, "--ckpt_every", "1"]))
    return out, summary, state


def test_trains_and_journals_the_loss_terms(full_run):
    out, summary, _ = full_run
    assert summary["step"] == 10
    losses = _losses(out)
    assert sorted(losses) == list(range(1, 11))
    assert all(np.isfinite(v) for v in losses.values())
    extra = {r["tag"]: r["value"] for r in _journal(out)
             if r["step"] == 10 and r["tag"] != "loss/total"}
    for k in ("cls_pos", "cls_neg", "adj", "grad_norm"):
        assert np.isfinite(extra[f"loss/{k}"]), k
    assert extra["loss/grad_norm"] > 0
    terms = sum(extra[f"loss/{k}"] for k in ("cls_pos", "cls_neg", "adj"))
    assert terms == pytest.approx(losses[10], rel=1e-6)
    ckpt = os.path.join(out, "checkpoints_")
    assert checkpoint_steps(ckpt) == [5, 10]
    with open(os.path.join(ckpt, "meta_10.json")) as f:
        assert json.load(f) == {"step": 10, "epoch": 2, "batch_in_epoch": 0}
    with open(os.path.join(out, "logfile", "train_.log")) as f:
        log = f.read()
    assert "it 10 loss" in log and "grad_norm=" in log and " lr 2e-05" in log


def test_stop_and_resume_is_bit_equal(full_run, tmp_path):
    """Stopped after 1 batch (as on SIGTERM) and resumed: the per-step
    losses of the uninterrupted run bit for bit, and bit-equal final
    parameters and optimizer state (dropout 0.1 on, every step's draws a
    function of (seed, step))."""
    out_full, _, _ = full_run
    out = str(tmp_path)
    stopped = train_vidvrd.main(BASE + ["--output_dir", out,
                                        "--stop_after_batches", "1"])
    assert stopped["step"] == 1
    with open(os.path.join(out, "checkpoints_", "meta_1.json")) as f:
        assert json.load(f) == {"step": 1, "epoch": 0, "batch_in_epoch": 1}
    resumed = train_vidvrd.main(BASE + ["--output_dir", out,
                                        "--from_checkpoint"])
    assert resumed["step"] == 10
    assert _losses(out) == _losses(out_full)
    (s1, a), (s2, b) = _final(out_full), _final(out)
    assert s1 == s2 == 10
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, st in a["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][k][name]), (k, name)


@pytest.mark.parametrize("extra,item", [
    (["--data_parallel"], "A9"), (["--mesh", "2,1"], "A9")],
    ids=lambda v: v if isinstance(v, str) else v[0])
def test_left_out_flags_raise(extra, item, full_run, tmp_path):
    """The multi-GPU flags are ported (ROADMAP A9): --data_parallel on the
    CPU is one rank, run in this process, whose journal is the plain run's
    bit for bit; a --mesh whose data axis does not divide the batch raises,
    as the JAX CLI's assert."""
    if extra[0] == "--data_parallel":
        summary = train_vidvrd.main(BASE + extra + [
            "--output_dir", str(tmp_path), "--ckpt_every", "1"])
        assert summary["mesh"] == [1, 1]
        assert _losses(str(tmp_path)) == _losses(full_run[0])
        return
    with pytest.raises(ValueError, match="divisible"):
        train_vidvrd.main(BASE + extra + ["--batch_size", "3"])


def test_int8_wire_trains(full_run, tmp_path):
    """--feat_dtype int8: features travel as int8 with a scale per video
    and BIG-C dequantizes them once in train mode; the run trains with
    finite losses near the float32 wire's (the quantization moves them a
    little, by 1e-2 relative at most here)."""
    out_full, _, _ = full_run
    out = str(tmp_path)
    summary = train_vidvrd.main(BASE + ["--output_dir", out,
                                        "--feat_dtype", "int8"])
    assert summary["step"] == 10
    got, want = _losses(out), _losses(out_full)
    assert sorted(got) == list(range(1, 11))
    assert got != want
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-2), k


def test_defaults_follow_the_jax_cli():
    args = train_vidvrd.parse_args(["--cfg_path", CFG])
    assert (args.ckpt_every, args.device, args.save_tag) == (10, "cuda", "")
    assert train_vidvrd.T_ABS == 4096
    # without --synthetic the CLI reads the config's train split, which
    # the demo config does not name
    with pytest.raises(ValueError, match="names no ann_dir"):
        train_vidvrd.main(["--cfg_path", CFG, "--device", "cpu"])


def test_eval_serves_the_trained_checkpoint(full_run, tmp_path):
    """eval_vidvrd --ckpt_path <checkpoint dir> loads the newest
    checkpoint's weights: bit-equal to the trained model in memory, the same
    outputs on a batch, and a full evaluation with finite metrics."""
    out, _, state = full_run
    ckpt_dir = os.path.join(out, "checkpoints_")
    mc = parse_config_py(CFG)["model_config"]
    cfg = BigCConfig.from_dict(mc)
    served = eval_vidvrd.build_model(cfg, mc, ckpt_dir).eval()
    trained = state.model.eval()
    for k, v in trained.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k
    records, feat = eval_vidvrd.synthetic_records(3, cfg, False)
    _, _, props, _ = next(iter(bucketed_batches(
        records, BucketSpec(feat_dim=feat), 3, with_gt=False)))
    props = props.to("cpu")
    with torch.no_grad():
        a, b = trained(props), served(props)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    res = eval_vidvrd.main(["--cfg_path", CFG, "--ckpt_path", ckpt_dir,
                            "--synthetic", "4", "--batch_size", "2",
                            "--device", "cpu", "--output_dir",
                            str(tmp_path)])
    assert res["n_videos"] == 4 and res["n_relations"] > 0
    assert np.isfinite(res["mAP"])
