"""The port's eval entry point against the JAX infer step + JAX evaluation on
the same records and weights, and the port's import boundary."""
import ast
import json
import pathlib

import numpy as np
import jax
import pytest
import torch

from vidsgg_big_tpu.data.bucketing import (BucketSpec as JaxBucketSpec,
                                           bucketed_batches as jax_batches)
from vidsgg_big_tpu.data.synthetic import make_video
from vidsgg_big_tpu.evaluation.convert import EvalFmtCvtor as JaxCvtor
from vidsgg_big_tpu.evaluation.metrics import (eval_relation_with_gt as
                                               jax_eval_relation)
from vidsgg_big_tpu.models import BigC as JaxBigC, BigCConfig as JaxBigCConfig
from vidsgg_big_tpu.train.steps import build_infer_step as jax_infer_step
from vidsgg_big_tpu.utils.config import parse_config_py

from vidsgg_big_tpu_torch.data import synthetic_vidvrd
from vidsgg_big_tpu_torch.evaluation import metrics as torch_metrics
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.models.transplant import bigc_state_dict_from_jax
from vidsgg_big_tpu_torch.tools import eval_vidvrd

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG_PATH = str(REPO / "experiments" / "demo" / "config_smoke_.py")
N_VIDEOS, BATCH = 4, 2


def _jax_model_and_weights():
    mc = parse_config_py(CFG_PATH)["model_config"]
    jcfg = JaxBigCConfig.from_dict(mc)
    model = JaxBigC(jcfg, enti_name_emb=np.zeros(
        (jcfg.num_enti_cats, jcfg.dim_clsme), np.float32))
    recs, feat = eval_vidvrd.synthetic_records(1, BigCConfig.from_dict(mc),
                                               False)
    first = next(iter(jax_batches(recs, JaxBucketSpec(feat_dim=feat), 1,
                                  with_gt=False)))
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), first[2]))
    params["params"]["bias_matrix"] = np.random.default_rng(1).normal(
        0, 0.5, params["params"]["bias_matrix"].shape).astype(np.float32)
    return model, params, BigCConfig.from_dict(mc)


def _jax_eval(model, params):
    """tools/eval_vidvrd.py's loop: JAX infer step, JAX converter, JAX
    metrics, on the records the port CLI draws."""
    topk = parse_config_py(CFG_PATH)["inference_config"]["topk"]
    infer = jax_infer_step(model, topk=topk)
    recs = [make_video(i, feat_dim=sum(synthetic_vidvrd.SMALL_DIMS))
            for i in range(N_VIDEOS)]
    cvt = JaxCvtor("vidvrd")
    pred, gt = {}, {}
    for _, rows, props, _ in jax_batches(
            recs, JaxBucketSpec(feat_dim=sum(synthetic_vidvrd.SMALL_DIMS)), BATCH,
            with_gt=False):
        trip = jax.device_get(infer(params, props))
        for i, (p, g) in enumerate(rows):
            pred.update(cvt.to_eval_format_pr(
                p, jax.tree_util.tree_map(lambda x: x[i], trip)))
            gt.update(cvt.to_eval_format_gt(g))
    return pred, jax_eval_relation(dataset_type="vidvrd", logger=None,
                                   prediction_results=pred, gt_relations=gt)


@pytest.fixture(scope="module")
def cli_vs_jax(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    model, params, cfg = _jax_model_and_weights()
    sd = bigc_state_dict_from_jax(params, cfg)
    ckpt = tmp / "bigc.pth"
    # a DataParallel-style checkpoint: the CLI strips "module."
    torch.save({f"module.{k}": v for k, v in sd.items()}, ckpt)
    out = eval_vidvrd.main([
        "--cfg_path", CFG_PATH, "--synthetic", str(N_VIDEOS),
        "--batch_size", str(BATCH), "--device", "cpu",
        "--ckpt_path", str(ckpt), "--output_dir", str(tmp),
        "--metrics_json", str(tmp / "metrics.json"), "--save_json_results"])
    with open(tmp / "VidVRDtest_predict_relations_torch.json") as f:
        port_pred = json.load(f)
    with open(tmp / "metrics.json") as f:
        port_metrics = json.load(f)
    jax_pred, jax_metrics = _jax_eval(model, params)
    return out, port_pred, port_metrics, json.loads(json.dumps(jax_pred)), \
        jax_metrics


def test_cli_predicted_relations_match_jax(cli_vs_jax):
    """The same relations in the same order; scores within 1e-5 (float32
    sums in another order), all else exactly equal."""
    out, port_pred, _, jax_pred, _ = cli_vs_jax
    assert out["n_videos"] == N_VIDEOS and out["n_batches"] == 2
    assert port_pred.keys() == jax_pred.keys()
    assert sum(len(v) for v in port_pred.values()) > 0
    for vid in jax_pred:
        assert len(port_pred[vid]) == len(jax_pred[vid])
        for a, b in zip(port_pred[vid], jax_pred[vid]):
            assert a["score"] == pytest.approx(b["score"], abs=1e-5)
            assert {k: v for k, v in a.items() if k != "score"} == \
                {k: v for k, v in b.items() if k != "score"}


def test_cli_metrics_match_jax(cli_vs_jax):
    _, _, port_metrics, _, (mean_ap, rec_at_n, prec_at_n) = cli_vs_jax
    assert port_metrics["mAP"] == pytest.approx(mean_ap, abs=1e-12)
    for k in (50, 100):
        assert port_metrics["recall"][str(k)] == pytest.approx(
            rec_at_n[k], abs=1e-12)
    for k, v in prec_at_n.items():
        assert port_metrics["precision"][str(k)] == pytest.approx(v,
                                                                   abs=1e-12)


def test_metrics_copy_matches_jax():
    """The port's metrics module scores one prediction set as the JAX one
    does, including tie order and the vIoU threshold edge."""
    from vidsgg_big_tpu.evaluation import metrics as jax_metrics
    rng = np.random.default_rng(3)

    def rel(trip, s, score=None):
        traj = (rng.uniform(0, 50, (s[1] - s[0], 2)).repeat(2, 1) +
                [0, 0, 40, 40]).tolist()
        r = {"triplet": trip, "duration": s, "sub_traj": traj,
             "obj_traj": traj}
        if score is not None:
            r["score"] = score
        return r

    gt = {"v0": [rel(["a", "p", "b"], (0, 10)), rel(["a", "q", "b"], (5, 9))],
          "v1": [rel(["c", "p", "b"], (2, 6))]}
    pred = {"v0": [dict(gt["v0"][0], score=0.9), rel(["a", "p", "b"],
                                                     (0, 10), 0.9),
                   dict(gt["v0"][1], score=0.3)],
            "v1": [rel(["c", "p", "b"], (2, 6), 0.5)]}
    assert torch_metrics.evaluate(gt, pred) == jax_metrics.evaluate(gt, pred)


def test_cli_refuses_missing_cuda():
    """--device cuda (the default) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_vidvrd.main(["--cfg_path", CFG_PATH, "--synthetic", "1"])


FORBIDDEN = {"jax", "flax", "ml_dtypes", "vidsgg_big_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO) for p in (REPO / "vidsgg_big_tpu_torch").rglob(
        "*.py")] + [pathlib.Path("chip_smoke.py")]), ids=str)
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    ml_dtypes or the JAX package (matched by exact top-level name, since
    vidsgg_big_tpu_torch shares its prefix)."""
    bad = [m for m in _imported_roots(REPO / path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
