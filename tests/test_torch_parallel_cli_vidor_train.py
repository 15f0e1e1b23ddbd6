"""``train_vidor``'s classification modes (BIG-C v7 and Base-C) under
``--mesh 2`` and ``--mesh 2,2`` on the CPU (gloo ranks the CLI spawns, one
torch thread each), against their unsharded runs on the demo VidOR
config's synthetic videos: two epochs of one step, the journal's losses to
rtol 1e-4 at both steps (BIG-C's dropout on), the first step's checkpoint
to rtol 1e-3, atol 1e-5 (see ``test_torch_parallel_cli_vidvrd``); ``2,2``
splits both models over its model ranks.  The grounding mode's runs are in
``test_torch_parallel_cli_grounding``.
"""
import os

import pytest
import torch

from test_torch_parallel_cli_vidvrd import same_training
from vidsgg_big_tpu_torch.tools import train_vidor

DEMO = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo")
COMMON = ["--epochs", "2", "--ckpt_every", "1", "--device", "cpu"]
CLS = ["--cfg_path", os.path.join(DEMO, "config_vidor_.py"), "--synthetic",
       "8", "--batch_size", "8"]
MODES = {"cls": CLS, "base": CLS + ["--train_baseline"]}
MESHES = {"2": [2, 1], "2,2": [2, 2]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MODES))
def unsharded(request, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(request.param))
    train_vidor.main(MODES[request.param] + COMMON + ["--output_dir", out])
    return request.param, out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_vidor_under_a_mesh(unsharded, mesh, tmp_path):
    mode, ref = unsharded
    summary = train_vidor.main(MODES[mode] + COMMON + [
        "--output_dir", str(tmp_path), "--mesh", mesh])
    assert summary["mesh"] == MESHES[mesh]
    same_training(str(tmp_path), ref, summary)
