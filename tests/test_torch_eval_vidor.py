"""The port's two-stage VidOR entry point against the JAX pipeline on the
same records, clip features and weights: JAX's BIG-C v7 (or, with
``--use_baseline``, Base-C) infer step on float32 or int8 features, its
grounding infer step, ``tools/eval_vidor._expand_bins``, its converter and
its metrics."""
import json
import os
import pathlib
import sys

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.data.bucketing import (BucketSpec as JaxBucketSpec,
                                           bucketed_batches as jax_batches,
                                           pick_unbounded as jax_pick)
from vidsgg_big_tpu.evaluation.convert import EvalFmtCvtor as JaxCvtor
from vidsgg_big_tpu.evaluation.metrics import (eval_relation_with_gt as
                                               jax_eval_relation)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.models import base_c as jax_base_c
from vidsgg_big_tpu.models import grounding as jax_grounding
from vidsgg_big_tpu.train.grounding_data import (
    prepare_grounding_queries as jax_queries)
from vidsgg_big_tpu.train.grounding_steps import (
    build_grounding_infer_step as jax_grounding_step)
from vidsgg_big_tpu.train.steps import build_infer_step as jax_infer_step
from vidsgg_big_tpu.train.steps import (
    build_basec_infer_step as jax_basec_infer_step)
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data.synthetic import clip_features
from vidsgg_big_tpu_torch.models.base_c import BaseCConfig
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.models.transplant import (
    basec_state_dict_from_jax, bigc_state_dict_from_jax,
    grounding_state_dict_from_jax)
from vidsgg_big_tpu_torch.tools import eval_vidor

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = str(REPO / "experiments" / "demo" / "config_vidor_.py")
GRD_CFG = str(REPO / "experiments" / "demo" / "config_grounding_.py")
N_VIDEOS, BATCH = 4, 2


def _jax_expand_bins():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import eval_vidor as jax_cli
    finally:
        sys.path.remove(str(REPO / "tools"))
    return jax_cli._expand_bins


def _records():
    return list(eval_vidor.synthetic_records(N_VIDEOS, 64, False))


def _jax_weights():
    mc = parse_config_py(CFG)["model_config"]
    jcfg = JaxBigCConfig.from_dict(mc, variant="v7")
    bigc = JaxBigC(jcfg)
    feat = eval_vidor.SMALL_DIM_FEAT + eval_vidor.DIM_CLASSEME
    first = next(iter(jax_batches(_records()[:1], JaxBucketSpec(
        feat_dim=feat), 1, with_gt=False)))
    bparams = jax.tree_util.tree_map(
        np.array, bigc.init(jax.random.PRNGKey(0), first[2]))
    bparams["params"]["bias_matrix"] = np.random.default_rng(1).normal(
        0, 0.5, bparams["params"]["bias_matrix"].shape).astype(np.float32)
    gmc = parse_config_py(GRD_CFG)["model_config"]
    grd = jax_grounding.GroundingModel(
        jax_grounding.GroundingConfig.from_dict(gmc))
    t, q = 32, 4
    gparams = jax.tree_util.tree_map(np.asarray, grd.init(
        jax.random.PRNGKey(1), np.zeros((1, t, gmc["dim_feat"]), np.float32),
        np.ones((1, t), bool), np.ones((1, q, 3), np.int32),
        np.zeros((1, q, 2), np.float32), np.ones((1, q), bool)))
    return (bigc, bparams, BigCConfig.from_dict(mc, variant="v7")), \
        (grd, gparams)


def _jax_basec_weights():
    """JAX Base-C weights at the demo config (a random bias prior) and the
    port's config."""
    mc = parse_config_py(CFG)["model_config"]
    model = jax_base_c.BaseC(jax_base_c.BaseCConfig.from_dict(mc))
    feat = eval_vidor.SMALL_DIM_FEAT + eval_vidor.DIM_CLASSEME
    first = next(iter(jax_batches(_records()[:1], JaxBucketSpec(
        feat_dim=feat), 1, with_gt=False)))
    params = jax.tree_util.tree_map(
        np.array, model.init(jax.random.PRNGKey(2), first[2]))
    params["params"]["bias_matrix"] = np.random.default_rng(4).normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    return model, params, BaseCConfig.from_dict(mc)


def _jax_pipeline(bigc, bparams, grd, gparams, baseline=False,
                  feat_dtype="float32"):
    """tools/eval_vidor.py's stages A and B with the JAX package, on the
    records and clip features the port CLI draws; ``bigc`` is the stage-A
    model (Base-C with ``baseline``)."""
    all_cfgs = parse_config_py(CFG)
    icfg = parse_config_py(GRD_CFG)["inference_config"]
    expand_bins = _jax_expand_bins()
    feat = eval_vidor.SMALL_DIM_FEAT + eval_vidor.DIM_CLASSEME
    build = jax_basec_infer_step if baseline else jax_infer_step
    infer = build(bigc, topk=all_cfgs["inference_config"]["topk"])
    results, rows = {}, []
    for _, brows, props, _ in jax_batches(
            _records(), JaxBucketSpec(
                feat_dim=feat, n_ladder=eval_vidor.STAGE_A_N_LADDER,
                feat_dtype=feat_dtype),
            BATCH, with_gt=False):
        trip = jax.device_get(infer(bparams, props))
        for i, (p, g) in enumerate(brows):
            results[p.video_name] = jax.tree_util.tree_map(
                lambda x: np.asarray(x[i]), trip)
            rows.append((p, g))
    ginfer = jax_grounding_step(grd, score_th=icfg["score_th"],
                                tiou_th=icfg["tiou_th"],
                                bins_th=icfg["bins_th"],
                                nms_th=icfg["nms_th"])
    cvt, pred, groups = JaxCvtor("vidor"), {}, {}
    for p, _ in rows:
        trip = results[p.video_name]
        v = trip.valid
        if not v.any():
            pred[cvt._reset_video_name(p.video_name)] = []
            continue
        vf = clip_features(int(p.video_name.split("_")[1]), p.video_len)
        groups.setdefault((jax_pick(int(v.sum())), jax_pick(vf.shape[0])),
                          []).append((p, trip.quintuples[v], trip.scores[v],
                                      trip.dura_inters[v], vf))
    b = max(BATCH, 4)
    for qb, tb in sorted(groups):
        chunk = groups[(qb, tb)]
        assert len(chunk) <= b
        feats = np.zeros((b, tb, 1024), np.float32)
        clips = np.zeros((b,), np.int32)
        qc = np.zeros((b, qb, 3), np.int32)
        temp = np.zeros((b, qb, 2), np.float32)
        qm = np.zeros((b, qb), bool)
        for i, (p, quint, _, duras, vf) in enumerate(chunk):
            nc = min(vf.shape[0], tb)
            feats[i, :nc], clips[i] = vf[:nc], nc
            m = quint.shape[0]
            q_cats, q_temp, _ = jax_queries(quint, duras, None, p.video_len)
            qc[i, :m], temp[i, :m], qm[i, :m] = q_cats, q_temp, True
        clip_mask = np.arange(tb)[None] < clips[:, None]
        pooled, probs, mask = jax.device_get(ginfer(
            gparams, feats, clip_mask, clips, qc, temp, qm))
        for i, (p, quint, scores3, duras, _) in enumerate(chunk):
            m = quint.shape[0]
            out = expand_bins(p, quint, scores3, duras, pooled[i, :m],
                              probs[i, :m], mask[i, :m])
            if out is None:
                pred[cvt._reset_video_name(p.video_name)] = []
            else:
                pred.update(cvt.to_eval_format_pr(p, out))
    gt = {}
    for _, g in rows:
        gt.update(cvt.to_eval_format_gt(g))
    return pred, jax_eval_relation(dataset_type="vidor", logger=None,
                                   prediction_results=pred, gt_relations=gt)


@pytest.fixture(scope="module")
def cli_vs_jax(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_vidor")
    (bigc, bparams, cfg), (grd, gparams) = _jax_weights()
    torch.save({f"module.{k}": v for k, v in
                bigc_state_dict_from_jax(bparams, cfg).items()},
               tmp / "bigc.pth")
    torch.save(grounding_state_dict_from_jax(gparams), tmp / "grd.pth")
    out = eval_vidor.main([
        "--cfg_path", CFG, "--grounding_cfg_path", GRD_CFG,
        "--synthetic", str(N_VIDEOS), "--batch_size", str(BATCH),
        "--device", "cpu", "--ckpt_path", str(tmp / "bigc.pth"),
        "--grounding_ckpt_path", str(tmp / "grd.pth"),
        "--output_dir", str(tmp), "--metrics_json", str(tmp / "m.json"),
        "--save_json_results"])
    with open(tmp / "VidORval_predict_relations_torch.json") as f:
        port_pred = json.load(f)
    with open(tmp / "m.json") as f:
        port_metrics = json.load(f)
    jax_pred, jax_metrics = _jax_pipeline(bigc, bparams, grd, gparams)
    return out, port_pred, port_metrics, json.loads(json.dumps(jax_pred)), \
        jax_metrics


def _same_relations(port_pred, jax_pred):
    """The same grounded relations in the same order; scores within 1e-5
    (float32 sums in another order), all else exactly equal."""
    assert port_pred.keys() == jax_pred.keys()
    assert sum(len(v) for v in port_pred.values()) > 0
    for vid in jax_pred:
        assert len(port_pred[vid]) == len(jax_pred[vid])
        for a, b in zip(port_pred[vid], jax_pred[vid]):
            assert a["score"] == pytest.approx(b["score"], abs=1e-5)
            assert {k: v for k, v in a.items() if k != "score"} == \
                {k: v for k, v in b.items() if k != "score"}


def test_cli_predicted_relations_match_jax(cli_vs_jax):
    """The same grounded relations in the same order; scores within 1e-5
    (float32 sums in another order), all else exactly equal."""
    out, port_pred, _, jax_pred, _ = cli_vs_jax
    assert out["n_videos"] == N_VIDEOS and out["stage_a_batches"] == 2
    assert out["stage_b_batches"], "no stage-B batch ran"
    _same_relations(port_pred, jax_pred)


def test_cli_metrics_match_jax(cli_vs_jax):
    _, _, port_metrics, _, (mean_ap, rec_at_n, _) = cli_vs_jax
    assert port_metrics["mAP"] == pytest.approx(mean_ap, abs=1e-12)
    for k in (50, 100):
        assert port_metrics["recall"][str(k)] == pytest.approx(
            rec_at_n[k], abs=1e-12)


@pytest.mark.parametrize("feat_dtype", ["float32", "int8"])
def test_cli_baseline_matches_jax(feat_dtype, tmp_path):
    """--use_baseline: Base-C's stage A (every ordered tracklet pair, the
    demo config's rt_triplets_topk -1) then grounding, on float32 and on
    int8 features, against JAX's Base-C infer step and pipeline: the same
    grounded relations and metrics.  The Base-C weights come as a
    train_vidor checkpoint directory, the grounding weights as a file."""
    (grd, gparams) = _jax_weights()[1]
    model, params, cfg = _jax_basec_weights()
    ckpt_dir = tmp_path / "checkpoints_base_torch"
    ckpt_dir.mkdir()
    torch.save({"model": basec_state_dict_from_jax(params, cfg)},
               ckpt_dir / "ckpt_3.pt")
    torch.save(grounding_state_dict_from_jax(gparams), tmp_path / "grd.pth")
    out = eval_vidor.main([
        "--use_baseline", "--cfg_path", CFG, "--grounding_cfg_path",
        GRD_CFG, "--synthetic", str(N_VIDEOS), "--batch_size", str(BATCH),
        "--device", "cpu", "--ckpt_path", str(ckpt_dir),
        "--grounding_ckpt_path", str(tmp_path / "grd.pth"),
        "--feat_dtype", feat_dtype, "--output_dir", str(tmp_path),
        "--metrics_json", str(tmp_path / "m.json"), "--save_json_results"])
    with open(tmp_path / "VidORval_predict_relations_torch.json") as f:
        port_pred = json.load(f)
    with open(tmp_path / "m.json") as f:
        port_metrics = json.load(f)
    jax_pred, (mean_ap, rec_at_n, _) = _jax_pipeline(
        model, params, grd, gparams, baseline=True, feat_dtype=feat_dtype)
    assert out["n_videos"] == N_VIDEOS and out["stage_b_batches"]
    assert len(out["stage_a_triplets"]) == N_VIDEOS
    _same_relations(port_pred, json.loads(json.dumps(jax_pred)))
    assert port_metrics["mAP"] == pytest.approx(mean_ap, abs=1e-12)
    assert port_metrics["recall"]["50"] == pytest.approx(rec_at_n[50],
                                                         abs=1e-12)


def test_cli_int8_stage_a_matches_jax(tmp_path):
    """--feat_dtype int8 on BIG-C v7: stage A alone (no grounding config)
    scores the same relations as JAX's int8 stage A."""
    (bigc, bparams, cfg), _ = _jax_weights()
    torch.save(bigc_state_dict_from_jax(bparams, cfg), tmp_path / "v7.pth")
    eval_vidor.main([
        "--cfg_path", CFG, "--synthetic", str(N_VIDEOS), "--batch_size",
        str(BATCH), "--device", "cpu", "--ckpt_path",
        str(tmp_path / "v7.pth"), "--feat_dtype", "int8", "--output_dir",
        str(tmp_path), "--save_json_results"])
    with open(tmp_path / "VidORval_predict_relations_torch.json") as f:
        port_pred = json.load(f)
    infer = jax_infer_step(bigc, topk=parse_config_py(CFG)[
        "inference_config"]["topk"])
    cvt, jax_pred = JaxCvtor("vidor"), {}
    feat = eval_vidor.SMALL_DIM_FEAT + eval_vidor.DIM_CLASSEME
    for _, brows, props, _ in jax_batches(
            _records(), JaxBucketSpec(
                feat_dim=feat, n_ladder=eval_vidor.STAGE_A_N_LADDER,
                feat_dtype="int8"), BATCH, with_gt=False):
        assert props.feats.dtype == np.int8
        trip = jax.device_get(infer(bparams, props))
        for i, (p, _) in enumerate(brows):
            jax_pred.update(cvt.to_eval_format_pr(p, jax.tree_util.tree_map(
                lambda x: np.asarray(x[i]), trip)))
    _same_relations(port_pred, json.loads(json.dumps(jax_pred)))


@pytest.mark.parametrize("flag", ["--mesh=2", "--zeroshot",
                                  "--save_hit_infos"])
def test_cli_left_out_flags_raise(flag):
    """The flags left out raise naming their ROADMAP item; --mesh is ported
    (A9) and raises where its data axis does not divide the batch of 1, as
    the JAX CLI's assert."""
    err, match = ((ValueError, "divisible") if flag.startswith("--mesh")
                  else (NotImplementedError, "ROADMAP A"))
    with pytest.raises(err, match=match):
        eval_vidor.main(["--cfg_path", CFG, "--synthetic", "1",
                         "--device", "cpu", flag])


def test_cli_refuses_missing_cuda():
    """--device cuda (the default) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_vidor.main(["--cfg_path", CFG, "--synthetic", "1"])
