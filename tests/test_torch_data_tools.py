"""The port's data and checkpoint CLIs against the JAX package's on the
same files, on the CPU: ``eval_traj_mAP`` and ``prepare_gts_for_eval`` on
written splits, ``prepare_data`` from a tiny GloVe file written here (the
same bytes out), ``dataloader_demo --device cpu`` (the same video and
batch counts), and ``convert_checkpoint`` of a reference-named ``.pth``
(the same tensors, JAX's transplant tables, the same predictions served,
JAX's legacy renames)."""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from vidsgg_big_tpu.data.bucketing import (BucketSpec as JaxBucketSpec,
                                           bucketed_batches as jax_batches)
from vidsgg_big_tpu.models import BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.models.base_c import BaseCConfig as JaxBaseCConfig
from vidsgg_big_tpu.models.transplant import (basec_params_from_torch,
                                              bigc_params_from_torch)

from vidsgg_big_tpu_torch.data import synthetic_raw
from vidsgg_big_tpu_torch.utils import categories
from vidsgg_big_tpu_torch.tools import (convert_checkpoint, dataloader_demo,
                                        eval_traj_mAP, eval_vidor,
                                        eval_vidvrd, prepare_data,
                                        prepare_gts_for_eval, train_vidvrd)
from vidsgg_big_tpu_torch.utils.config import parse_config_py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "experiments", "demo")
VRD_CFG = os.path.join(DEMO, "config_smoke_.py")
VIDOR_CFG = os.path.join(DEMO, "config_vidor_.py")
GRD_CFG = os.path.join(DEMO, "config_grounding_.py")
REF_CFG = os.path.join(DEMO, "config_.py")


def jax_tool(name):
    """A CLI module of the JAX package's tools/ (imported as its tests do,
    under a name of its own)."""
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tools_{name}", os.path.join(tools, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


def _cli_args(flags: dict) -> list:
    out = []
    for k, v in flags.items():
        if v is True:
            out.append(f"--{k}")
        elif v not in (None, False):
            out += [f"--{k}", str(v)]
    return out


# ---- eval_traj_mAP, prepare_gts_for_eval ----------------------------------

@pytest.mark.parametrize("kind,use_pku", [("vidor", False),
                                          ("vidvrd", False),
                                          ("vidvrd", True)])
def test_eval_traj_map_matches_jaxs_cli(tmp_path, kind, use_pku):
    """The split's proposals scored against its GT trajectories; the log
    goes beside the config, so each run reads a copy under tmp_path."""
    cfg = shutil.copy(VIDOR_CFG if kind == "vidor" else VRD_CFG,
                      tmp_path / "config_.py")
    flags = dict(cfg_path=str(cfg), dataset_type=kind, split="test",
                 use_pku=use_pku, synthetic=3,
                 synthetic_root=str(tmp_path / "split"))
    got = eval_traj_mAP.main(_cli_args(flags))
    want = jax_tool("eval_traj_mAP").main(argparse.Namespace(**flags))
    assert got["mean_ap"] == want and got["n_videos"] == 3
    assert 0 < want <= 1 + 1e-12


@pytest.mark.parametrize("kind,split", [("vidvrd", "test"),
                                        ("vidor", "validation")])
def test_prepare_gts_for_eval_matches_jaxs_cli(tmp_path, kind, split):
    if kind == "vidvrd":
        ann = synthetic_raw.write_synthetic_vidvrd(str(tmp_path), 3,
                                                   "test")["ann_dir"]
    else:
        ann = synthetic_raw.write_synthetic_vidor(
            str(tmp_path), 3, "val", with_video_features=False)["ann_dir"]
    flags = dict(dataset_type=kind, anno_rpath=ann, split=split)
    gts = prepare_gts_for_eval.main(_cli_args(dict(
        flags, save_path=tmp_path / "port.json")))
    jax_tool("prepare_gts_for_eval").main(argparse.Namespace(
        **flags, save_path=str(tmp_path / "jax.json")))
    with open(tmp_path / "port.json", "rb") as f, \
            open(tmp_path / "jax.json", "rb") as g:
        assert f.read() == g.read()
    assert len(gts) == 3


# ---- prepare_data ----------------------------------------------------------

def _write_glove(path):
    """A GloVe text file holding a seeded vector for every word of the five
    vocabularies."""
    words = set()
    for names in (categories.VIDVRD_ENTITIES, categories.PKU_VIDVRD_ENTITIES,
                  categories.VIDVRD_PREDICATES, categories.VIDOR_ENTITIES,
                  categories.VIDOR_PREDICATES):
        for name in names:
            for alt in name.split("(")[0].split("/"):
                words.update(alt.split("_"))
    words.discard("")
    rng = np.random.default_rng(0)
    with open(path, "w", encoding="utf-8") as f:
        for w in sorted(words):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in rng.normal(
                size=300)) + "\n")


@pytest.mark.parametrize("kind,use_pku", [("vidvrd", False),
                                          ("vidvrd", True),
                                          ("vidor", False)])
def test_prepare_data_writes_jaxs_bytes(tmp_path, kind, use_pku):
    _write_glove(tmp_path / "glove.txt")
    logits = tmp_path / "logits"
    logits.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        np.save(logits / f"000{i}_video{i}_logits.npy",
                rng.normal(size=(5, 81)).astype(np.float32))
    outs = {}
    for who in ("port", "jax"):
        flags = dict(output_dir=str(tmp_path / who / "prepared"),
                     glove_path=str(tmp_path / "glove.txt"),
                     cfg_path=VIDOR_CFG if kind == "vidor" else VRD_CFG,
                     dataset_type=kind, use_pku=use_pku,
                     logits_dir=str(logits),
                     classeme_out_dir=str(tmp_path / who / "classeme"),
                     synthetic=3, synthetic_root=str(tmp_path / "split"))
        if who == "port":
            prepare_data.main(_cli_args(flags))
        else:
            jax_tool("prepare_data").main(argparse.Namespace(**flags))
        outs[who] = {os.path.relpath(os.path.join(d, f), tmp_path / who):
                     open(os.path.join(d, f), "rb").read()
                     for d, _, fs in os.walk(tmp_path / who) for f in fs}
    assert outs["port"] == outs["jax"]
    tag = "vidor" if kind == "vidor" else (
        "vidvrd_pku" if use_pku else "vidvrd")
    assert len(outs["port"]) == 5 + 1 + 2
    bias = np.load(tmp_path / "port" / "prepared" /
                   f"pred_bias_matrix_{tag}.npy")
    assert bias.any()


# ---- dataloader_demo -------------------------------------------------------

@pytest.mark.parametrize("extra", [
    dict(cfg_path=VRD_CFG),
    dict(cfg_path=VIDOR_CFG, dataset_type="vidor"),
    dict(cfg_path=REF_CFG, dataset_class="pku_i3d")],
    ids=["vidvrd", "vidor", "dataset_class"])
def test_dataloader_demo_counts_match_jax(tmp_path, monkeypatch, extra):
    """The videos, proposals and predicates the JAX CLI prints, and the
    batches of JAX's bucketer over the same split.  The JAX CLI itself
    stops at its histogram: it unpacks the 4-part (N, T, tg, gb) key of its
    bucketer's GT batches into two names (``tools/dataloader_demo.py:75``),
    so its batch counts come from the JAX bucketer it calls."""
    flags = dict(extra, synthetic=3, synthetic_root=str(tmp_path / "split"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = dataloader_demo.main(_cli_args(dict(flags, device="cpu")))
    port_lines = out.getvalue().splitlines()
    jax_demo = jax_tool("dataloader_demo")
    monkeypatch.setattr(sys, "argv", ["dataloader_demo.py"] +
                        _cli_args(flags))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(ValueError, match="unpack"):
        jax_demo.main()
    jax_lines = out.getvalue().splitlines()
    assert port_lines[:2] == jax_lines[:2]
    assert got["n_videos"] == 3 and port_lines[-1] == "dataloader demo OK"

    cfg = parse_config_py(flags["cfg_path"])
    key = (f"{extra['dataset_class']}_test_dataset_config"
           if "dataset_class" in extra else "test_dataset_config")
    dataset, _ = jax_demo.make_dataset(
        cfg[key], extra.get("dataset_type", "vidvrd"), synthetic=3,
        synthetic_root=flags["synthetic_root"])
    items = [(it[-2], it[-1]) for it in dataset]
    keys = [k[:2] for k, *_ in jax_batches(items, JaxBucketSpec(
        feat_dim=items[0][0].features[0].shape[1]), batch_size=2)]
    assert got["n_batches"] == len(keys)
    assert got["buckets"] == {f"{n}x{t}": keys.count((n, t))
                              for n, t in sorted(set(keys))}


# ---- convert_checkpoint ------------------------------------------------------

MODELS = {"bigc_vidvrd": VRD_CFG, "bigc_vidor": VIDOR_CFG,
          "base_c": VIDOR_CFG, "grounding": GRD_CFG}


def _reference_pth(tmp_path, model_name, wrap=False):
    """A reference-named .pth of a seeded port model (weights moved off
    the converter's own init), with DataParallel prefixes; returns (path,
    the unprefixed state)."""
    mc = parse_config_py(MODELS[model_name])["model_config"]
    model = convert_checkpoint.build(model_name, mc)
    gen = torch.Generator().manual_seed(7)
    sd = {k: v + torch.randn(v.shape, generator=gen) * 0.1
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    raw = {f"module.{k}": v for k, v in sd.items()}
    path = tmp_path / f"{model_name}.pth"
    torch.save({"model_state_dict": raw, "epoch": 80} if wrap else raw,
               path)
    return path, sd


@pytest.mark.parametrize("model_name", list(MODELS))
def test_convert_checkpoint_keeps_the_tensors_and_jaxs_tables(tmp_path,
                                                              model_name):
    path, sd = _reference_pth(tmp_path, model_name,
                              wrap=model_name == "bigc_vidor")
    out = tmp_path / "converted"
    res = convert_checkpoint.main(["--torch_ckpt", str(path), "--cfg_path",
                                   MODELS[model_name], "--model",
                                   model_name, "--out", str(out)])
    ckpt = torch.load(out / "ckpt_0.pt", weights_only=True)
    assert ckpt["step"] == 0 and not ckpt["optimizer"]["state"]
    assert ckpt["model"].keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(ckpt["model"][k], v), k
    mc = parse_config_py(MODELS[model_name])["model_config"]
    if model_name == "grounding":
        want = {}
    elif model_name == "base_c":
        _, want = basec_params_from_torch(sd, JaxBaseCConfig.from_dict(mc))
    else:
        _, want = bigc_params_from_torch(sd, JaxBigCConfig.from_dict(
            mc, variant="v10" if model_name == "bigc_vidvrd" else "v7"))
    want = {k: v for k, v in want.items() if v is not None}
    assert res["tables"] == sorted(want)
    if want:
        got = np.load(out / "tables.npz")
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    else:
        assert not os.path.exists(out / "tables.npz")


def test_converted_checkpoint_serves_and_resumes(tmp_path):
    """eval_vidvrd --ckpt_path on the converted directory writes the
    .pth's predictions; train_vidvrd --from_checkpoint resumes it."""
    path, _ = _reference_pth(tmp_path, "bigc_vidvrd")
    out = tmp_path / "converted"
    convert_checkpoint.main(["--torch_ckpt", str(path), "--cfg_path",
                             VRD_CFG, "--model", "bigc_vidvrd", "--out",
                             str(out)])
    preds = []
    for name, extra in (("pth", ["--ckpt_path", str(path)]),
                        ("dir", ["--ckpt_path", str(out), "--tables_path",
                                 str(out / "tables.npz")])):
        eval_vidvrd.main(["--cfg_path", VRD_CFG, "--synthetic", "2",
                          "--device", "cpu", "--output_dir",
                          str(tmp_path / name), "--save_json_results"]
                         + extra)
        with open(tmp_path / name /
                  "VidVRDtest_predict_relations_torch.json") as f:
            preds.append(json.load(f))
    assert preds[0] == preds[1] and any(preds[0].values())
    summary = train_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", "2", "--batch_size", "2",
        "--epochs", "1", "--device", "cpu", "--output_dir",
        str(tmp_path / "train"), "--from_checkpoint", "--ckpt_path",
        str(out)])
    assert summary["step"] == 1


def test_converted_grounding_checkpoint_serves_eval_vidor(tmp_path):
    """eval_vidor --grounding_ckpt_path on the converted directory writes
    the .pth's two-stage predictions."""
    path, _ = _reference_pth(tmp_path, "grounding")
    out = tmp_path / "converted"
    convert_checkpoint.main(["--torch_ckpt", str(path), "--cfg_path",
                             GRD_CFG, "--model", "grounding", "--out",
                             str(out)])
    preds = []
    for name, ckpt in (("pth", path), ("dir", out)):
        eval_vidor.main(["--cfg_path", VIDOR_CFG, "--grounding_cfg_path",
                         GRD_CFG, "--grounding_ckpt_path", str(ckpt),
                         "--synthetic", "2", "--device", "cpu",
                         "--output_dir", str(tmp_path / name),
                         "--save_json_results"])
        with open(tmp_path / name /
                  "VidORval_predict_relations_torch.json") as f:
            preds.append(json.load(f))
    assert preds[0] == preds[1] and any(preds[0].values())


def test_legacy_keys_are_jaxs_renames(tmp_path):
    keys = ["pred_nodes_init", "decoder_layers.0.fc_msg_recv.1.0.weight",
            "encoder_layers.1.layers.linear1.bias",
            "fc_pred2logits.0.weight", "pos_embedding"]
    sd = dict.fromkeys(keys, 0)
    assert convert_checkpoint.replace_legacy_keys(sd) == \
        jax_tool("convert_checkpoint").replace_legacy_keys(sd)
    path, want = _reference_pth(tmp_path, "bigc_vidvrd")
    legacy = {k.replace("pred_query_init", "pred_nodes_init").replace(
        "fc_rolewise", "fc_msg_recv"): v
        for k, v in torch.load(path, weights_only=True).items()}
    assert legacy.keys() != {f"module.{k}" for k in want}
    torch.save(legacy, tmp_path / "legacy.pth")
    convert_checkpoint.main(["--torch_ckpt", str(tmp_path / "legacy.pth"),
                             "--cfg_path", VRD_CFG, "--model",
                             "bigc_vidvrd", "--out", str(tmp_path / "out"),
                             "--legacy_keys"])
    got = torch.load(tmp_path / "out" / "ckpt_0.pt",
                     weights_only=True)["model"]
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with pytest.raises(RuntimeError, match="pred_nodes_init"):
        convert_checkpoint.main([
            "--torch_ckpt", str(tmp_path / "legacy.pth"), "--cfg_path",
            VRD_CFG, "--model", "bigc_vidvrd", "--out",
            str(tmp_path / "strict")])
