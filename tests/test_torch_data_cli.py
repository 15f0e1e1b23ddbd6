"""The port's CLIs on splits in the reference layout, on the CPU.

``train_vidvrd`` and ``train_vidor`` (cls, baseline, grounding) read a demo
split written with ``--synthetic N --synthetic_root DIR``; their losses are
bit-equal with the device record cache on and off (and across a stop and
resume).  ``eval_vidvrd`` on such a split gives the relations and metrics
of the JAX package's inference on the same files with the same weights,
with the GT of the annotations or of ``--gt_json``; ``eval_vidor`` runs
both stages on a VidOR split, its clip features read from disk.
"""
import json
import os

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.data.bucketing import (BucketSpec as JaxBucketSpec,
                                           bucketed_batches as jax_batches)
from vidsgg_big_tpu.data.dataset import VidVRDDataset as JaxVidVRDDataset
from vidsgg_big_tpu.evaluation.convert import EvalFmtCvtor as JaxCvtor
from vidsgg_big_tpu.evaluation.metrics import (eval_relation_with_gt as
                                               jax_eval_relation)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.train.steps import build_infer_step as jax_infer_step
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data import annotations, synthetic_raw
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.models.transplant import bigc_state_dict_from_jax
from vidsgg_big_tpu_torch.tools import (common, eval_vidor, eval_vidvrd,
                                        train_vidor, train_vidvrd)

DEMO = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo")
VRD_CFG = os.path.join(DEMO, "config_smoke_.py")
VIDOR_CFG = os.path.join(DEMO, "config_vidor_.py")
GRD_CFG = os.path.join(DEMO, "config_grounding_.py")


def _losses(out_dir):
    with open(os.path.join(out_dir, "logfile", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "loss/total"}


# ---- training -----------------------------------------------------------

@pytest.fixture(scope="module")
def vrd_runs(tmp_path_factory):
    """train_vidvrd on a 6-video pku_i3d split (3 epochs of 3 steps), cache
    on and off, and a run stopped after 2 steps then resumed (cache on)."""
    tmp = tmp_path_factory.mktemp("vrd")
    base = ["--cfg_path", VRD_CFG, "--synthetic", "6", "--synthetic_root",
            str(tmp / "split"), "--batch_size", "2", "--epochs", "3",
            "--device", "cpu", "--ckpt_every", "1"]
    runs = {}
    for name, extra in (("on", []), ("off", ["--device_cache_gb", "0"])):
        runs[name] = (str(tmp / name), train_vidvrd.main(
            base + extra + ["--output_dir", str(tmp / name)]))
    out = str(tmp / "resumed")
    train_vidvrd.main(base + ["--output_dir", out, "--stop_after_batches",
                              "2"])
    runs["resumed"] = (out, train_vidvrd.main(base + [
        "--output_dir", out, "--from_checkpoint"]))
    return runs


def test_train_vidvrd_reads_the_split_and_fills_the_cache(vrd_runs):
    out, summary = vrd_runs["on"]
    assert summary["step"] == 9 and summary["n_videos"] == 6
    pipe = summary["pipeline"]
    assert pipe["device_cache"] == dict(
        videos=6, bytes=pipe["device_cache"]["bytes"], complete=True,
        over_budget=False, dropped=False, first_cached_epoch=1)
    # epoch 0 parsed and cached every video (one more read for the feature
    # width); the cached epochs packed nothing
    assert pipe["dataset_seconds"]["parse"][1] == 6
    assert len(pipe["pack_s"]) == 3
    off = vrd_runs["off"][1]["pipeline"]
    assert "device_cache" not in off and len(off["pack_s"]) == 9


def test_train_vidvrd_losses_bit_equal_with_cache_on_and_off(vrd_runs):
    on, off = _losses(vrd_runs["on"][0]), _losses(vrd_runs["off"][0])
    assert sorted(on) == list(range(1, 10))
    assert all(np.isfinite(v) for v in on.values())
    assert on == off


def test_train_vidvrd_resumes_bit_equal_from_disk(vrd_runs):
    """The resumed epoch 0 fast-forwards its staged batches (their slots
    freed unshipped) and leaves the cache incomplete; the full epoch 1
    fills it (on the host path, where the uninterrupted run's epoch 1 was
    cached), and epoch 2 runs from it."""
    assert _losses(vrd_runs["resumed"][0]) == _losses(vrd_runs["on"][0])
    cache = vrd_runs["resumed"][1]["pipeline"]["device_cache"]
    assert cache["complete"] and cache["first_cached_epoch"] == 2


def test_train_vidvrd_reads_the_tables_path(tmp_path):
    """--tables_path: the frozen name embedding of tables.npz."""
    table = np.random.default_rng(0).normal(size=(36, 300)).astype(
        np.float32)
    np.savez(tmp_path / "tables.npz", enti_name_emb=table)
    summary = train_vidvrd.main([
        "--cfg_path", VRD_CFG, "--synthetic", "2", "--synthetic_root",
        str(tmp_path / "split"), "--batch_size", "2", "--epochs", "1",
        "--device", "cpu", "--output_dir", str(tmp_path), "--tables_path",
        str(tmp_path / "tables.npz")])
    ckpt = torch.load(os.path.join(summary["ckpt_dir"], "ckpt_1.pt"),
                      weights_only=True)
    assert np.array_equal(ckpt["model"]["EntiNameEmb"].numpy(), table)


@pytest.mark.parametrize("mode", ["cls", "base"])
def test_train_vidor_losses_bit_equal_with_cache_on_and_off(tmp_path, mode):
    base = (["--train_baseline"] if mode == "base" else []) + [
        "--cfg_path", VIDOR_CFG, "--synthetic", "5", "--synthetic_root",
        str(tmp_path / "split"), "--batch_size", "2", "--epochs", "2",
        "--device", "cpu"]
    on = train_vidor.main(base + ["--output_dir", str(tmp_path / "on")])
    off = train_vidor.main(base + ["--output_dir", str(tmp_path / "off"),
                                   "--device_cache_gb", "0"])
    assert on["step"] == off["step"] >= 6
    cache = on["pipeline"]["device_cache"]
    assert cache["complete"] and cache["first_cached_epoch"] == 1
    losses = _losses(str(tmp_path / "on"))
    assert all(np.isfinite(v) for v in losses.values())
    assert losses == _losses(str(tmp_path / "off"))


def test_train_vidor_grounding_reads_the_clip_features(tmp_path):
    """The grounding stage trains on the split's clip features, its name
    tables from the config's GloVe tables where the files exist."""
    enti = np.random.default_rng(1).normal(size=(81, 32)).astype(np.float32)
    np.save(tmp_path / "enti.npy", enti)
    cfg = tmp_path / "config_grounding_.py"
    with open(GRD_CFG) as f:
        text = f.read()
    cfg.write_text(text + f"\nmodel_config['EntiNameEmb_path'] = "
                          f"{str(tmp_path / 'enti.npy')!r}\n")
    summary = train_vidor.main([
        "--train_grounding", "--cfg_path", str(cfg), "--synthetic", "3",
        "--synthetic_root", str(tmp_path / "split"), "--batch_size", "2",
        "--epochs", "1", "--device", "cpu", "--output_dir",
        str(tmp_path / "out"), "--seed", "3"])
    assert summary["step"] == 2 and summary["n_videos"] == 3
    assert all(np.isfinite(v) for v in _losses(str(tmp_path / "out"))
               .values())
    assert summary["pipeline"]["dataset_seconds"]["parse"][1] >= 3
    model, _ = _grounding_at_init(str(cfg), 3)
    assert np.array_equal(model.EntiNameEmb.detach().numpy(), enti)


def _grounding_at_init(cfg_path, seed):
    """The grounding trainer's model before its first step."""
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       GroundingModel)
    mc = parse_config_py(cfg_path)["model_config"]
    gcfg = GroundingConfig.from_dict(mc)
    model = GroundingModel(gcfg, generator=torch.Generator().manual_seed(
        seed))
    enti, _, _ = common.load_tables(mc, gcfg.num_enti_cats,
                                    gcfg.num_pred_cats, gcfg.dim_clsme)
    with torch.no_grad():
        if common.has_table(mc, "EntiNameEmb_path"):
            model.EntiNameEmb.copy_(torch.from_numpy(enti))
    return model, gcfg


def test_cli_defaults_follow_the_jax_clis():
    for mod in (train_vidvrd, train_vidor):
        args = mod.parse_args(["--cfg_path", VRD_CFG])
        assert args.device_cache_gb == 4.0 and args.synthetic_root is None
    args = train_vidvrd.parse_args(["--cfg_path", VRD_CFG, "--use_pku"])
    assert args.use_pku and args.fmt is None


# ---- evaluation ---------------------------------------------------------

N_EVAL, BATCH = 4, 2


@pytest.fixture(scope="module")
def eval_vs_jax(tmp_path_factory):
    """eval_vidvrd --synthetic 4 --synthetic_root on transplanted weights,
    with the annotations' GT and with --gt_json, and JAX's inference on the
    same files."""
    tmp = tmp_path_factory.mktemp("eval")
    root = tmp / "split"
    # the files the CLI writes (again, the same bytes) with --synthetic 4
    # --synthetic_root; JAX reads them through its own cache directory
    cfg = synthetic_raw.write_synthetic_vidvrd(str(root), N_EVAL, "test")
    ds = JaxVidVRDDataset(**dict(cfg, cache_dir=str(tmp / "jax_cache")))
    mc = parse_config_py(VRD_CFG)["model_config"]
    jcfg = JaxBigCConfig.from_dict(mc)
    model = JaxBigC(jcfg, enti_name_emb=np.zeros(
        (jcfg.num_enti_cats, jcfg.dim_clsme), np.float32))
    first = next(iter(jax_batches(ds, JaxBucketSpec(feat_dim=80), 1,
                                  with_gt=False)))
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), first[2]))
    params["params"]["bias_matrix"] = np.random.default_rng(1).normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    torch.save(bigc_state_dict_from_jax(params, BigCConfig.from_dict(mc)),
               tmp / "bigc.pth")
    annotations.prepare_gts_for_eval(annotations.VidVRD(
        cfg["ann_dir"], ["test"]), "test", str(tmp / "gt.json"))
    port = {}
    for gt, extra in (("anno", []), ("json", ["--gt_json",
                                              str(tmp / "gt.json")])):
        port[gt] = eval_vidvrd.main([
            "--cfg_path", VRD_CFG, "--synthetic", str(N_EVAL),
            "--synthetic_root", str(root), "--batch_size", str(BATCH),
            "--device", "cpu", "--ckpt_path", str(tmp / "bigc.pth"),
            "--output_dir", str(tmp / gt), "--save_json_results"] + extra)
        with open(tmp / gt / "VidVRDtest_predict_relations_torch.json") as f:
            port[gt]["pred"] = json.load(f)
    infer = jax_infer_step(model, topk=parse_config_py(VRD_CFG)[
        "inference_config"]["topk"])
    cvt = JaxCvtor("vidvrd")
    pred, gt_rel = {}, {}
    for _, rows, props, _ in jax_batches(ds, JaxBucketSpec(feat_dim=80),
                                         BATCH, with_gt=False):
        trip = jax.device_get(infer(params, props))
        for i, (p, g) in enumerate(rows):
            pred.update(cvt.to_eval_format_pr(
                p, jax.tree_util.tree_map(lambda x: x[i], trip)))
            gt_rel.update(cvt.to_eval_format_gt(g))
    want = {"anno": jax_eval_relation(dataset_type="vidvrd", logger=None,
                                      prediction_results=pred,
                                      gt_relations=gt_rel),
            "json": jax_eval_relation(dataset_type="vidvrd", logger=None,
                                      prediction_results=pred,
                                      gt_relations_path=str(tmp / "gt.json"))}
    return port, json.loads(json.dumps(pred)), want


def test_eval_vidvrd_from_disk_predicts_jaxs_relations(eval_vs_jax):
    port, jax_pred, _ = eval_vs_jax
    got = port["anno"]["pred"]
    assert port["anno"]["n_videos"] == N_EVAL
    assert got.keys() == jax_pred.keys()
    assert sum(len(v) for v in got.values()) > 0
    for vid in jax_pred:
        assert len(got[vid]) == len(jax_pred[vid])
        for a, b in zip(got[vid], jax_pred[vid]):
            assert a["score"] == pytest.approx(b["score"], abs=1e-5)
            assert {k: v for k, v in a.items() if k != "score"} == \
                {k: v for k, v in b.items() if k != "score"}


@pytest.mark.parametrize("gt", ["anno", "json"])
def test_eval_vidvrd_from_disk_metrics_match_jax(eval_vs_jax, gt):
    port, _, want = eval_vs_jax
    mean_ap, rec_at_n, _ = want[gt]
    assert port[gt]["mAP"] == pytest.approx(mean_ap, abs=1e-12)
    for k in (50, 100):
        assert port[gt]["recall"][str(k)] == pytest.approx(rec_at_n[k],
                                                           abs=1e-12)


def test_eval_vidor_two_stages_from_disk(tmp_path):
    """Stage A on the split's records, stage B on its clip features (the
    T bucket from the .npy header), scored against the annotations; the
    second run reads the .npz cache."""
    base = ["--cfg_path", VIDOR_CFG, "--grounding_cfg_path", GRD_CFG,
            "--synthetic", "3", "--synthetic_root", str(tmp_path / "split"),
            "--batch_size", "2", "--device", "cpu", "--topk", "10"]
    cold = eval_vidor.main(base + ["--output_dir", str(tmp_path / "a")])
    warm = eval_vidor.main(base + ["--output_dir", str(tmp_path / "b")])
    assert cold["n_videos"] == 3 and cold["n_relations"] > 0
    assert np.isfinite(cold["mAP"]) and cold["stage_b_batches"]
    assert cold["dataset_seconds"]["parse"][1] == 3
    assert "parse" not in warm["dataset_seconds"]
    for k in ("mAP", "n_relations", "stage_b_batches", "stage_a_triplets"):
        assert cold[k] == warm[k]


@pytest.mark.parametrize("flags,fmt", [(["--fmt", "mega"], "mega"),
                                       (["--use_pku", "--fmt", "pku"],
                                        "pku")])
def test_eval_vidvrd_reads_the_format_the_flags_pick(tmp_path, flags, fmt):
    """--fmt wins over --use_pku (exp1 is PKU without I3D): the split is
    written and read in that format, by a model without I3D features."""
    cfg = tmp_path / "config_.py"
    with open(VRD_CFG) as f:
        cfg.write_text(f.read() + "\nmodel_config['dim_i3d'] = 0\n")
    out = eval_vidvrd.main(["--cfg_path", str(cfg), "--synthetic", "3",
                            "--synthetic_root", str(tmp_path / "split"),
                            "--batch_size", "2", "--device", "cpu",
                            "--output_dir", str(tmp_path)] + flags)
    assert out["n_videos"] == 3 and np.isfinite(out["mAP"])
    assert os.listdir(tmp_path / "split" / "cache") == [
        f"SYNTH_{fmt}_64x16_VidVRDtest_th_5-50-100"]
