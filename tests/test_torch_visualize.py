"""Visualisation of the port (``utils/visualize.py``, ``tools/visualize.py``)
against the JAX package's, on the CPU (it has no device path).

Frames are compared pixel for pixel; the CLIs' written videos by name and
frame count.  The modules import without OpenCV and raise naming it at use.
"""
import argparse
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vidsgg_big_tpu.utils import visualize as jax_vis  # noqa: E402
from vidsgg_big_tpu_torch.tools import visualize as port_cli  # noqa: E402
from vidsgg_big_tpu_torch.utils import visualize as vis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_cli():
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_visualize", os.path.join(tools, "visualize.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


def _relations(seed, n=14, video_len=60):
    """Challenge-format predicted relations with random boxes, scores (some
    tied) and durations."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, video_len - 10))
        e = int(rng.integers(s + 1, video_len + 1))
        boxes = lambda: [[float(v) for v in (x, y, x + w, y + h)]
                         for x, y, w, h in rng.uniform(0, 300, (e - s, 4))]
        out.append({"triplet": [f"o{rng.integers(3)}", f"p{rng.integers(4)}",
                                f"o{rng.integers(3)}"],
                    "score": float(rng.choice([0.5, rng.uniform()])),
                    "duration": [s, e], "sub_traj": boxes(),
                    "obj_traj": boxes()})
    return out


def _frame_count(path):
    cap = cv2.VideoCapture(str(path))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


@pytest.mark.parametrize("topk", [3, 10, 20])
def test_prediction_insts_equal_jax(topk):
    rels = _relations(0)
    assert vis.prediction_insts(rels, topk=topk) == \
        jax_vis.prediction_insts(rels, topk=topk)


def test_rendered_frames_equal_jax():
    """The same objects and captions on blank canvases and on given frames:
    every frame pixel-equal."""
    objs, rels = vis.prediction_insts(_relations(1), topk=8)
    rng = np.random.default_rng(2)
    given = [rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)
             for _ in range(60)]
    for frames in (60, given):
        got = vis.render_video_annotations(frames, objs, rels)
        want = jax_vis.render_video_annotations(frames, objs, rels)
        assert len(got) == len(want) == 60
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if isinstance(frames, int):      # boxes were drawn
            assert any((g != 255).any() for g in got)


def _jax_args(**kw):
    flags = dict(anno=None, prediction_json=None, video_dir=None,
                 out_dir="visualized", topk=10, max_videos=0, fps=25,
                 canvas="640x360", synthetic=0, synthetic_root=None)
    return argparse.Namespace(**dict(flags, **kw))


def test_cli_gt_mode_renders_as_jax(tmp_path):
    """--synthetic writes a split and renders its GT: the same videos, each
    with the JAX CLI's frame count."""
    got = port_cli.main(["--synthetic", "2", "--synthetic_root",
                         str(tmp_path / "port_split"), "--out_dir",
                         str(tmp_path / "port")])
    want = jax_cli().main(_jax_args(synthetic=2,
                                    synthetic_root=str(tmp_path / "jax"),
                                    out_dir=str(tmp_path / "jax_out")))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert _frame_count(g) == _frame_count(w) > 0


def test_cli_prediction_mode_renders_as_jax(tmp_path):
    """A submission-packaged prediction JSON: the same videos (an empty one
    skipped), each with the JAX CLI's frame count."""
    path = tmp_path / "pred.json"
    path.write_text(json.dumps({"version": "VERSION 1.0", "results": {
        "vid_a": _relations(3), "vid_b": _relations(4, video_len=40),
        "vid_c": []}}))
    got = port_cli.main(["--prediction_json", str(path), "--out_dir",
                         str(tmp_path / "port"), "--topk", "5",
                         "--canvas", "320x180"])
    want = jax_cli().main(_jax_args(prediction_json=str(path),
                                    out_dir=str(tmp_path / "jax"), topk=5,
                                    canvas="320x180"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["vid_a.mp4", "vid_b.mp4"]
    for g, w in zip(got, want):
        assert _frame_count(g) == _frame_count(w) > 0


def test_modules_import_without_opencv(monkeypatch):
    """With cv2 hidden both modules import, and drawing raises an
    ImportError that names cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    fresh_vis = importlib.reload(vis)
    importlib.reload(port_cli)
    objs, rels = fresh_vis.prediction_insts(_relations(5), topk=2)
    assert len(objs) == 4
    with pytest.raises(ImportError, match="cv2"):
        fresh_vis.render_video_annotations(3, objs, rels)
    with pytest.raises(ImportError, match="cv2"):
        fresh_vis.read_video_frames("missing.mp4")
    monkeypatch.undo()
    importlib.reload(vis)
    importlib.reload(port_cli)
