"""The port's grounding entry points under a mesh on the CPU (gloo ranks
the CLI spawns, one torch thread each), against their unsharded runs on
the demo configs' synthetic videos.

``train_vidor --train_grounding`` under ``--mesh 2`` and ``--mesh 2,2``:
the grounding model is never split, so ``2,2`` runs four data ranks, as
the JAX CLI; two epochs of one step, the losses to rtol 1e-4 at both steps
(dropout on), the first step's checkpoint to rtol 1e-3, atol 1e-5.
``eval_vidor`` (BIG-C v7 stage A, grounding stage B) under ``--mesh 2`` and
``--mesh 2,2`` (stage A split over the model ranks), and ``--use_baseline
--mesh 2,2``, which runs Base-C on four data ranks (the JAX CLI's quirk,
``tools/eval_vidor.py:102-107``): the same metrics and relations, scores to
1e-5.
"""
import json
import os

import pytest
import torch

from test_torch_parallel_cli_vidvrd import same_relations, same_training
from vidsgg_big_tpu_torch.tools import eval_vidor, train_vidor

DEMO = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo")
TRAIN = ["--cfg_path", os.path.join(DEMO, "config_grounding_.py"),
         "--train_grounding", "--synthetic", "4", "--batch_size", "4",
         "--epochs", "2", "--ckpt_every", "1", "--device", "cpu"]
EVAL = ["--cfg_path", os.path.join(DEMO, "config_vidor_.py"),
        "--grounding_cfg_path", os.path.join(DEMO, "config_grounding_.py"),
        "--synthetic", "8", "--batch_size", "4", "--device", "cpu",
        "--save_json_results"]
RUNS = {"2": ([], "2", [2, 1]), "2,2": ([], "2,2", [2, 2]),
        "baseline-2,2": (["--use_baseline"], "2,2", [4, 1])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unsharded_train(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train"))
    train_vidor.main(TRAIN + ["--output_dir", out])
    return out


@pytest.mark.parametrize("mesh,want", [("2", [2, 1]), ("2,2", [4, 1])])
def test_train_grounding_under_a_mesh(unsharded_train, mesh, want,
                                      tmp_path):
    summary = train_vidor.main(TRAIN + ["--output_dir", str(tmp_path),
                                        "--mesh", mesh])
    assert summary["mesh"] == want
    same_training(str(tmp_path), unsharded_train, summary)


@pytest.fixture(scope="module")
def unsharded_eval(tmp_path_factory):
    out = {}
    for flags in ([], ["--use_baseline"]):
        d = str(tmp_path_factory.mktemp("eval"))
        out[bool(flags)] = d, eval_vidor.main(EVAL + flags +
                                              ["--output_dir", d])
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_eval_vidor_under_a_mesh(unsharded_eval, run, tmp_path):
    flags, mesh, shape = RUNS[run]
    ref, want = unsharded_eval[bool(flags)]
    got = eval_vidor.main(EVAL + flags + ["--output_dir", str(tmp_path),
                                          "--mesh", mesh])
    assert got["mesh"] == shape
    for key in ("mAP", "recall", "precision", "n_videos", "n_relations",
                "stage_a_triplets"):
        assert got[key] == want[key], key
    assert want["n_relations"] > 0
    name = "VidORval_predict_relations_torch.json"
    with open(os.path.join(str(tmp_path), name)) as f, \
            open(os.path.join(ref, name)) as g:
        same_relations(json.load(f), json.load(g))
