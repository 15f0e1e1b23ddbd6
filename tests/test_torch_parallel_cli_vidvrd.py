"""The VidVRD entry points of the port under ``--mesh 2`` and ``--mesh 2,2``
on the CPU (gloo ranks the CLI spawns, one torch thread each), against
their unsharded runs on the demo BIG-C config's synthetic videos.

``train_vidvrd`` (two epochs of one step): the journal's losses to rtol
1e-4 at both steps (dropout 0.1 on), the parameters of the first step's
checkpoint to rtol 1e-3, atol 1e-5 (the JAX test's, which compares one
step: a parameter with no gradient but rounding, such as the attention's
key bias, drifts by about the learning rate x 0.1 a step under Adam), the
same checkpoint keys and shapes.  ``eval_vidvrd``: the same
metrics and relations, scores to 1e-5.
"""
import json
import os

import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.tools import eval_vidvrd, train_vidvrd
from vidsgg_big_tpu_torch.train.train_state import checkpoint_steps

CFG = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo",
                   "config_smoke_.py")
TRAIN = ["--cfg_path", CFG, "--synthetic", "8", "--batch_size", "8",
         "--epochs", "2", "--ckpt_every", "1", "--device", "cpu"]
EVAL = ["--cfg_path", CFG, "--synthetic", "8", "--batch_size", "4",
        "--device", "cpu", "--save_json_results"]
MESHES = {"2": [2, 1], "2,2": [2, 2]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Spawned ranks take this process's threads over their count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def journal(out):
    with open(os.path.join(out, "logfile", "metrics.jsonl")) as f:
        return {r["step"]: r["value"] for r in map(json.loads, f)
                if r["tag"] == "loss/total"}


def first_checkpoint(ckpt_dir):
    step = checkpoint_steps(ckpt_dir)[0]
    return torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                      weights_only=True)


def same_training(out, ref, summary):
    got, want = journal(out), journal(ref)
    assert sorted(got) == sorted(want) and len(want) >= 2
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=1e-4)
    a = first_checkpoint(summary["ckpt_dir"])
    b = first_checkpoint(os.path.join(ref, os.path.basename(
        summary["ckpt_dir"])))
    assert a["step"] == b["step"] == 1
    assert a["model"].keys() == b["model"].keys()
    for k, v in b["model"].items():
        np.testing.assert_allclose(a["model"][k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def same_relations(a, b):
    assert a.keys() == b.keys()
    for video, rels in b.items():
        assert len(a[video]) == len(rels), video
        for x, y in zip(a[video], rels):
            assert x["triplet"] == y["triplet"]
            assert x["duration"] == y["duration"]
            np.testing.assert_allclose(x["score"], y["score"], rtol=1e-5,
                                       atol=1e-5)


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("unsharded"))
    train_vidvrd.main(TRAIN + ["--output_dir", out + "/train"])
    metrics = eval_vidvrd.main(EVAL + ["--output_dir", out + "/eval"])
    return out, metrics


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_vidvrd_under_a_mesh(unsharded, mesh, tmp_path):
    ref, _ = unsharded
    summary = train_vidvrd.main(TRAIN + ["--output_dir", str(tmp_path),
                                         "--mesh", mesh])
    assert summary["mesh"] == MESHES[mesh]
    same_training(str(tmp_path), ref + "/train", summary)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_vidvrd_under_a_mesh(unsharded, mesh, tmp_path):
    ref, want = unsharded
    got = eval_vidvrd.main(EVAL + ["--output_dir", str(tmp_path),
                                   "--mesh", mesh])
    assert got["mesh"] == MESHES[mesh]
    for key in ("mAP", "recall", "precision", "n_videos", "n_relations"):
        assert got[key] == want[key], key
    name = "VidVRDtest_predict_relations_torch.json"
    with open(os.path.join(str(tmp_path), name)) as f, \
            open(os.path.join(ref, "eval", name)) as g:
        same_relations(json.load(f), json.load(g))
