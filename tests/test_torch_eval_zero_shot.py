"""The eval CLIs' JAX flags on the CPU: ``--zeroshot`` (both protocols),
``--json_results_path``, ``--save_hit_infos``, ``--save_infer_result`` and
``--save_tag``, each held against the JAX package's functions on the
port's saved predictions and the same split's GT, read by the JAX
package's own dataset; then ``eval_fraction_recall`` on the port's hit
infos and ``cvt_results`` on its predictions, against the JAX CLIs on the
same files.  Equality is the tolerance throughout."""
import argparse
import importlib.util
import json
import lzma
import os
import pickle
import sys
import zipfile

import numpy as np
import pytest

from vidsgg_big_tpu.data.dataset import (VidORDataset as JaxVidORDataset,
                                         VidVRDDataset as JaxVidVRDDataset)
from vidsgg_big_tpu.evaluation.convert import EvalFmtCvtor as JaxCvtor
from vidsgg_big_tpu.evaluation.metrics import (eval_relation_with_gt as
                                               jax_eval_relation)
from vidsgg_big_tpu.evaluation.zero_shot import (
    collect_train_triplets as jax_train_triplets,
    evaluate_zero_shot as jax_zero_shot)

from vidsgg_big_tpu_torch.data import synthetic_raw
from vidsgg_big_tpu_torch.data.dataset import VidORDataset, VidVRDDataset
from vidsgg_big_tpu_torch.data.synthetic_vidvrd import SyntheticVidVRDSet
from vidsgg_big_tpu_torch.evaluation.convert import EvalFmtCvtor
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.models.triplets import Triplets
from vidsgg_big_tpu_torch.tools import (cvt_results, eval_fraction_recall,
                                        eval_vidor, eval_vidvrd)
from vidsgg_big_tpu_torch.tools.common import metrics_dict
from vidsgg_big_tpu_torch.utils.config import parse_config_py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "experiments", "demo")
VRD_CFG = os.path.join(DEMO, "config_smoke_.py")
VIDOR_CFG = os.path.join(DEMO, "config_vidor_.py")
N_VIDEOS = 3


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


def _load(path):
    with open(path) as f:
        return json.load(f)


def _jax_gt(cls, cfg, kind, cache):
    """{video: GT relations} of the split, through the JAX package's
    dataset (its own cache) and converter."""
    ds = cls(**dict(cfg, cache_dir=cache))
    cvt, gt = JaxCvtor(kind), {}
    for name in ds.video_name_list:
        gt.update(cvt.to_eval_format_gt(ds.get_data(name)[1]))
    return gt


def _same_triplets(pkl, dataset, pred, use_pku=False):
    """The pickled triplets ({video: {field: array}}) hold the port's
    Triplets fields and convert back into the saved predictions."""
    cvt = EvalFmtCvtor("vidvrd" if isinstance(dataset, VidVRDDataset)
                       else "vidor")
    fields = {f for f in Triplets.__dataclass_fields__}
    back = {}
    for name, d in pkl.items():
        assert set(d) == fields and all(isinstance(v, np.ndarray)
                                        for v in d.values())
        back.update(cvt.to_eval_format_pr(dataset.get_data(name)[0],
                                          Triplets(**d), use_pku=use_pku))
    assert json.loads(json.dumps(back)) == pred


@pytest.fixture(scope="module")
def vrd(tmp_path_factory):
    """eval_vidvrd --zeroshot --save_json_results --save_infer_result
    --save_tag t on a 3-video split on disk (its train split written by
    the zero-shot setting, seed 1)."""
    tmp = tmp_path_factory.mktemp("vrd")
    root = str(tmp / "split")
    cfg = synthetic_raw.write_synthetic_vidvrd(root, N_VIDEOS, "test")
    out = eval_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", str(N_VIDEOS),
        "--synthetic_root", root, "--batch_size", "2", "--device", "cpu",
        "--output_dir", str(tmp), "--zeroshot", "--save_json_results",
        "--save_infer_result", "--save_tag", "t", "--metrics_json",
        str(tmp / "metrics.json")])
    gt = _jax_gt(JaxVidVRDDataset, cfg, "vidvrd", str(tmp / "jax_cache"))
    return dict(tmp=tmp, root=root, cfg=cfg, out=out, gt=gt,
                pred=_load(tmp / "VidVRDtest_predict_relations_t.json"),
                metrics=_load(tmp / "metrics.json"),
                train=jax_train_triplets("vidvrd", cfg["ann_dir"]))


def test_eval_vidvrd_zero_shot_block_matches_jax(vrd):
    assert os.path.exists(os.path.join(vrd["cfg"]["ann_dir"], "train"))
    test_trips = {tuple(r["triplet"]) for rels in vrd["gt"].values()
                  for r in rels}
    assert test_trips - vrd["train"], "no zero-shot triplet"
    want = jax_zero_shot(vrd["gt"], vrd["pred"], vrd["train"])
    assert vrd["metrics"]["zero_shot"] == json.loads(json.dumps(
        metrics_dict(want)))
    assert vrd["out"]["zero_shot"] == metrics_dict(want)
    plain = jax_eval_relation(dataset_type="vidvrd", logger=None,
                              prediction_results=vrd["pred"],
                              gt_relations=vrd["gt"])
    assert {k: vrd["metrics"][k] for k in ("mAP", "recall", "precision")} \
        == json.loads(json.dumps(metrics_dict(plain)))


def test_eval_vidvrd_save_tag_and_infer_result(vrd):
    tmp = vrd["tmp"]
    assert os.path.exists(tmp / "logfile" / "eval_t.log")
    with open(tmp / "VidVRDtest_infer_result_t.pkl", "rb") as f:
        pkl = pickle.load(f)
    assert len(pkl) == N_VIDEOS
    _same_triplets(pkl, VidVRDDataset(**vrd["cfg"]), vrd["pred"])


@pytest.mark.parametrize("old", [False, True])
def test_eval_vidvrd_rescores_the_saved_json(vrd, old):
    """--json_results_path: the inference run's metrics, with no model and
    no device (the default --device cuda is never resolved)."""
    tmp = vrd["tmp"]
    mj = str(tmp / f"rescored_{old}.json")
    res = eval_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", str(N_VIDEOS),
        "--synthetic_root", vrd["root"], "--output_dir", str(tmp),
        "--json_results_path",
        str(tmp / "VidVRDtest_predict_relations_t.json"), "--zeroshot",
        "--metrics_json", mj, "--save_tag", f"rescore_{old}"]
        + (["--old_zeroshot_eval"] if old else []))
    got = _load(mj)
    want = jax_zero_shot(vrd["gt"], vrd["pred"], vrd["train"],
                         use_old_zeroshot_eval=old)
    assert got["zero_shot"] == json.loads(json.dumps(metrics_dict(want)))
    assert res["n_videos"] == N_VIDEOS
    if not old:
        assert got == vrd["metrics"]


def test_eval_vidvrd_in_memory_zero_shot_with_train_anno_rpath(vrd, tmp_path):
    """The in-memory records with --train_anno_rpath: JAX's zero-shot
    metrics of the saved predictions against the records' GT."""
    res = eval_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", "2", "--device", "cpu",
        "--output_dir", str(tmp_path), "--zeroshot", "--train_anno_rpath",
        vrd["cfg"]["ann_dir"], "--save_json_results"])
    data = SyntheticVidVRDSet(2, BigCConfig.from_dict(
        parse_config_py(VRD_CFG)["model_config"]), False)
    cvt, gt = JaxCvtor("vidvrd"), {}
    for i in range(2):
        gt.update(cvt.to_eval_format_gt(data[i][1]))
    pred = _load(tmp_path / "VidVRDtest_predict_relations_torch.json")
    assert res["zero_shot"] == metrics_dict(jax_zero_shot(
        json.loads(json.dumps(gt)), pred, vrd["train"]))
    # re-scored against the same records' GT graphs
    again = eval_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", "2", "--output_dir",
        str(tmp_path), "--zeroshot", "--train_anno_rpath",
        vrd["cfg"]["ann_dir"], "--json_results_path",
        str(tmp_path / "VidVRDtest_predict_relations_torch.json")])
    keys = ("mAP", "recall", "precision", "zero_shot")
    assert {k: again[k] for k in keys} == {k: res[k] for k in keys}


@pytest.mark.parametrize("cli,cfg", [(eval_vidvrd, VRD_CFG),
                                     (eval_vidor, VIDOR_CFG)],
                         ids=["eval_vidvrd", "eval_vidor"])
def test_in_memory_zero_shot_without_train_annotations_raises(cli, cfg):
    with pytest.raises(ValueError, match="--train_anno_rpath.*"
                                         "--synthetic_root"):
        cli.main(["--cfg_path", cfg, "--synthetic", "1", "--device", "cpu",
                  "--zeroshot"])


@pytest.fixture(scope="module")
def vidor(tmp_path_factory):
    """eval_vidor (stage A) --save_hit_infos --zeroshot --save_json_results
    --save_infer_result --save_tag t on a 3-video val split on disk."""
    tmp = tmp_path_factory.mktemp("vidor")
    root = str(tmp / "split")
    cfg = synthetic_raw.write_synthetic_vidor(root, N_VIDEOS, "val")
    out = eval_vidor.main([
        "--cfg_path", VIDOR_CFG, "--synthetic", str(N_VIDEOS),
        "--synthetic_root", root, "--batch_size", "2", "--device", "cpu",
        "--output_dir", str(tmp), "--save_hit_infos", "--zeroshot",
        "--save_json_results", "--save_infer_result", "--save_tag", "t",
        "--metrics_json", str(tmp / "metrics.json")])
    gt = _jax_gt(JaxVidORDataset, cfg, "vidor", str(tmp / "jax_cache"))
    with open(tmp / "hit_infos_t.pkl", "rb") as f:
        hits = pickle.load(f)
    return dict(tmp=tmp, root=root, cfg=cfg, out=out, gt=gt, hits=hits,
                pred=_load(tmp / "VidORval_predict_relations_t.json"),
                metrics=_load(tmp / "metrics.json"))


def test_eval_vidor_hit_infos_match_jax(vidor):
    *_, want = jax_eval_relation(
        dataset_type="vidor", logger=None, prediction_results=vidor["pred"],
        gt_relations=vidor["gt"], return_hit_infos=True)
    assert vidor["hits"].keys() == want.keys() and len(want) == N_VIDEOS
    for vid, (scores, ids) in want.items():
        got_scores, got_ids = vidor["hits"][vid]
        assert got_scores.dtype == scores.dtype and \
            np.array_equal(got_scores, scores)
        assert got_ids.dtype == ids.dtype and np.array_equal(got_ids, ids)


def test_eval_vidor_zero_shot_and_files(vidor):
    tmp = vidor["tmp"]
    train = jax_train_triplets("vidor", vidor["cfg"]["ann_dir"])
    test_trips = {tuple(r["triplet"]) for rels in vidor["gt"].values()
                  for r in rels}
    assert train and test_trips - train, "no zero-shot triplet"
    want = jax_zero_shot(vidor["gt"], vidor["pred"], train)
    assert vidor["metrics"]["zero_shot"] == json.loads(json.dumps(
        metrics_dict(want)))
    assert os.path.exists(tmp / "logfile" / "eval_t.log")
    with open(tmp / "VidORval_infer_results_t.pkl", "rb") as f:
        pkl = pickle.load(f)
    _same_triplets(pkl, VidORDataset(**vidor["cfg"]), vidor["pred"])


@pytest.mark.parametrize("hits", ["port", "random"])
def test_eval_fraction_recall_matches_jaxs_cli(vidor, tmp_path, hits):
    """eval_fraction_recall on the port's hit infos (and on seeded random
    ones over the same split), against JAX's CLI on the same files."""
    path = vidor["tmp"] / "hit_infos_t.pkl"
    if hits == "random":
        rng = np.random.default_rng(0)
        ds = VidORDataset(**vidor["cfg"])
        infos = {}
        for name in ds.video_name_list:
            p = ds.get_data(name)[1].num_preds
            infos[name.split("_")[1]] = (rng.random(p), rng.choice(
                [-1, 0, 49, 50, 51, 100, 150, 999, 1000, 1001], p))
        path = tmp_path / "hit_infos_random.pkl"
        with open(path, "wb") as f:
            pickle.dump(infos, f)
    flags = dict(cfg_path=VIDOR_CFG, hit_info_path=str(path),
                 experiment_dir=str(tmp_path), synthetic=N_VIDEOS,
                 synthetic_root=vidor["root"])
    got = eval_fraction_recall.main([a for k, v in flags.items()
                                     for a in (f"--{k}", str(v))])
    want = jax_tool("eval_fraction_recall").main(argparse.Namespace(**flags))
    assert {k: got[k] for k in want} == want
    assert got["n_videos"] == N_VIDEOS
    if hits == "random":
        assert want["dataset_level"]["overall"][1000] > 0


def test_cvt_results_matches_jaxs_cli(vidor, tmp_path):
    src = str(vidor["tmp"] / "VidORval_predict_relations_t.json")
    res = cvt_results.main(["--results_json", src, "--output_dir",
                            str(tmp_path / "port")])
    jax_tool("cvt_results").main(argparse.Namespace(
        results_json=src, output_dir=str(tmp_path / "jax")))
    zips = [zipfile.ZipFile(tmp_path / d / "submission.zip")
            for d in ("port", "jax")]
    names = [z.namelist() for z in zips]
    assert names[0] == names[1] and len(names[0]) == res["n_videos"] == \
        N_VIDEOS
    for name in names[0]:
        a, b = (json.loads(lzma.decompress(z.read(name))) for z in zips)
        assert a == b and list(a["results"]) == [name[:-len(".json.xz")]]
