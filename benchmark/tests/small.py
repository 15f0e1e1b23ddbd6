"""The cells at small widths and shapes, for CPU tests: every key the
benchmark reads, shrunk, the rest (limits, thresholds) as committed."""
from __future__ import annotations

from benchmark.harness.runtime import Cell

CONFIGS = {
    "bigc_v10_exp2": dict(dim_ffn=32, dim_enti=32, dim_pred=32, dim_att=32,
                          dim_feat=48, dim_clsme=12, dim_i3d=16,
                          num_querys=12, n_deco_layers=2),
    "grounding_vidor": dict(dim_feat=32, dim_clsme=12, dim_hidden=16),
}
TRAFFIC = {
    "serve_bigc": dict(batch=2, slots=10, tracklets=8, frames=16, min_len=4,
                       video_len=40),
    "train_bigc": dict(batch=2, slots=10, tracklets=8, frames=16, min_len=4,
                       video_len=40, gt_slots=4, gt_trajs=3, pred_slots=6,
                       gt_preds=4, gt_min_len=10, gt_max_start=5),
    "serve_grounding": dict(batch=2, queries=6, clips=16, video_len=100),
    "train_grounding": dict(batch=2, pred_slots=6, gt_preds=4, gt_trajs=4,
                            clips=16, video_len=100),
}


def small_cell(name: str, **kw) -> Cell:
    cell = Cell(name, **kw)
    cell.config["model_config"].update(CONFIGS[cell.entry["config"]])
    cell.traffic.update(TRAFFIC[cell.traffic["driver"]], trace_steps=2)
    if "sample_batches" in cell.traffic:
        cell.traffic["sample_batches"] = 3
    return cell
