"""The port's raw-format writers and parsers against the JAX package's, on
the same files: ``synthetic_raw`` writes the same bytes, and every parser
(row loop and fast), the GT builder, the proposal record, the gap
interpolation and the duration helpers give the same values, exactly."""
import filecmp
import json
import os

import numpy as np
import pytest

from vidsgg_big_tpu.data import interpolate as jax_interp
from vidsgg_big_tpu.data import parse as jax_parse
from vidsgg_big_tpu.data import synthetic_raw as jax_raw
from vidsgg_big_tpu.ops import temporal as jax_temporal
from vidsgg_big_tpu.utils import categories as jax_cats

from vidsgg_big_tpu_torch.data import interpolate, parse, synthetic_raw
from vidsgg_big_tpu_torch.ops import temporal
from vidsgg_big_tpu_torch.utils import categories

N_VIDEOS = 3


def _same_tree(a, b):
    """Equal values and dtypes, recursively (lists, tuples, arrays,
    dataclasses, scalars)."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for k in a.__dataclass_fields__:
            _same_tree(getattr(a, k), getattr(b, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def _same_files(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert names
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("fmt", ["mega", "pku", "pku_i3d"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_write_synthetic_vidvrd_same_bytes(tmp_path, fmt, split):
    cj = jax_raw.write_synthetic_vidvrd(str(tmp_path / "j"), N_VIDEOS, split,
                                        fmt, seed=2)
    cp = synthetic_raw.write_synthetic_vidvrd(str(tmp_path / "p"), N_VIDEOS,
                                              split, fmt, seed=2)
    _same_files(tmp_path / "j", tmp_path / "p")
    assert {k: v for k, v in cj.items() if not k.endswith("dir")} == \
        {k: v for k, v in cp.items() if not k.endswith("dir")}


@pytest.mark.parametrize("split", ["train", "val"])
def test_write_synthetic_vidor_same_bytes(tmp_path, split):
    jax_raw.write_synthetic_vidor(str(tmp_path / "j"), N_VIDEOS, split,
                                  seed=1)
    synthetic_raw.write_synthetic_vidor(str(tmp_path / "p"), N_VIDEOS, split,
                                        seed=1)
    _same_files(tmp_path / "j", tmp_path / "p")


def test_write_synthetic_vidor_test_split_same_bytes(tmp_path):
    """The annotation-free test split writes real video files (OpenCV)."""
    pytest.importorskip("cv2")
    jax_raw.write_synthetic_vidor(str(tmp_path / "j"), 2, "test",
                                  video_len=20)
    synthetic_raw.write_synthetic_vidor(str(tmp_path / "p"), 2, "test",
                                        video_len=20)
    _same_files(tmp_path / "j", tmp_path / "p")


def test_recipe_reaches_make_video(tmp_path):
    """A recipe argument changes the records (and the cache tag); none
    keeps the JAX package's."""
    cfg = synthetic_raw.write_synthetic_vidvrd(
        str(tmp_path), 1, "test", "pku", seed=0, video_len=60,
        n_gt_trajs=2, n_distractors=1, n_preds=2)
    assert cfg["cache_tag"].endswith("_L60_n_distractors1_n_gt_trajs2"
                                     "_n_preds2")
    rows = np.load(os.path.join(cfg["proposal_dir"],
                                "ILSVRC2015_synth_00000000.npy"))
    assert len(np.unique(rows[:, 1])) == 3           # 2 GT + 1 distractor


def _rows(rng, d, n_tids=5, bg_prob=0.2, gap_prob=0.2, bg="pku"):
    """Tracklet rows in (tid, fid) order with gaps and background rows:
    pku's full rows with cat <= 0 (``bg="pku"``), mega/vidor's 6-wide rows
    (``"len6"``) or none."""
    rows = []
    for tid in rng.permutation(n_tids * 2)[:n_tids]:
        f = int(rng.integers(0, 8))
        cat = int(rng.integers(1, 12))
        for _ in range(int(rng.integers(3, 25))):
            box = rng.uniform(1, 50, 4).round(2).tolist()
            if bg == "len6" and rng.uniform() < bg_prob:
                rows.append([float(f), float(tid)] + box)
            else:
                is_bg = bg == "pku" and rng.uniform() < bg_prob
                rows.append([float(f), float(tid)] + box
                            + ([0.0, -1.0] if is_bg else
                               [float(rng.uniform(0.2, 1)), float(cat)])
                            + rng.uniform(1, 50, 4).round(2).tolist()
                            + rng.normal(size=d).round(3).tolist())
            f += 1 + int(rng.uniform() < gap_prob) * int(rng.integers(1, 4))
    return rows


D, MIN_FRAMES = 6, 5


def _object_array(rows):
    arr = np.empty(len(rows), object)
    for i, r in enumerate(rows):
        arr[i] = r
    return arr


def _cases():
    rng = np.random.default_rng(5)
    full = np.asarray(_rows(rng, D), np.float64)            # pku rows
    uniform = np.asarray(_rows(rng, D, bg=None), np.float64)
    mixed = _rows(rng, D, bg="len6")
    i3d = np.concatenate([np.zeros((full.shape[0], 12)),
                          rng.normal(size=(full.shape[0], 4))], axis=1)
    clsme = rng.normal(size=(len(mixed), 3))
    clsme_uniform = rng.normal(size=(uniform.shape[0], 3))
    return {
        "mega": ("parse_tracklets_mega", (mixed, D, MIN_FRAMES), {}),
        "mega_uniform": ("parse_tracklets_mega", (uniform, D, MIN_FRAMES),
                         {}),
        "mega_fast": ("parse_tracklets_mega_fast",
                      (_object_array(mixed), D, MIN_FRAMES), {}),
        "mega_fast_uniform": ("parse_tracklets_mega_fast",
                              (uniform, D, MIN_FRAMES), {}),
        "pku": ("parse_tracklets_pku", (full, D, MIN_FRAMES), {}),
        "pku_i3d": ("parse_tracklets_pku", (full, D, MIN_FRAMES),
                    dict(i3d_features=i3d, dim_i3d=4)),
        "pku_zero_i3d": ("parse_tracklets_pku", (full, D, MIN_FRAMES),
                         dict(i3d_features=i3d, dim_i3d=4, zero_i3d=True)),
        "pku_fast": ("parse_tracklets_pku_fast", (full, D, MIN_FRAMES), {}),
        "pku_fast_i3d": ("parse_tracklets_pku_fast", (full, D, MIN_FRAMES),
                         dict(i3d_features=i3d, dim_i3d=4)),
        "pku_fast_zero_i3d": ("parse_tracklets_pku_fast",
                              (full, D, MIN_FRAMES),
                              dict(i3d_features=i3d, dim_i3d=4,
                                   zero_i3d=True)),
        "vidor": ("parse_tracklets_vidor", (mixed, clsme, D, MIN_FRAMES), {}),
        "vidor_no_classeme": ("parse_tracklets_vidor",
                              (uniform, None, D, MIN_FRAMES), {}),
        "vidor_fast": ("parse_tracklets_vidor_fast",
                       (_object_array(mixed), clsme, D, MIN_FRAMES), {}),
        "vidor_fast_uniform": ("parse_tracklets_vidor_fast",
                               (uniform, clsme_uniform, D, MIN_FRAMES), {}),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_parser_matches_jax(case):
    """Category votes, durations, interpolated boxes and features, the
    zero I3D of _myFaster18 and min_frames_th: equal field for field."""
    fn, args, kw = _cases()[case]
    got = getattr(parse, fn)(*args, **kw)
    want = getattr(jax_parse, fn)(*args, **kw)
    assert len(want[0]) > 0
    _same_tree(got, want)


@pytest.mark.parametrize("fmt", ["mega", "pku", "pku_i3d"])
def test_parsers_on_written_files_match_jax(tmp_path, fmt):
    """Both parsers of a format on the .npy files synthetic_raw writes, and
    the record built from them, against JAX's."""
    cfg = synthetic_raw.write_synthetic_vidvrd(str(tmp_path), 2, "test", fmt)
    for v in range(2):
        name = f"ILSVRC2015_synth_00{v:06d}"
        rows = np.load(os.path.join(cfg["proposal_dir"], name + ".npy"))
        kw = {}
        if fmt == "pku_i3d":
            kw = dict(i3d_features=np.load(os.path.join(
                cfg["i3d_dir"], name + ".npy")), dim_i3d=cfg["dim_i3d"])
        base = "parse_tracklets_" + ("mega" if fmt == "mega" else "pku")
        for fn in (base, base + "_fast"):
            got = getattr(parse, fn)(rows, 64, 5, **kw)
            _same_tree(got, getattr(jax_parse, fn)(rows, 64, 5, **kw))
        rec = parse.build_proposal_record(name, got, 3, score_th=0.1,
                                          video_len=120, video_wh=(9, 7))
        _same_tree(rec, jax_parse.build_proposal_record(
            name, got, 3, score_th=0.1, video_len=120, video_wh=(9, 7)))


@pytest.mark.parametrize("split,max_preds", [("train", 3), ("test", 0)])
def test_gt_annotation_matches_jax(tmp_path, split, max_preds):
    """The GT of the written annotation JSONs: merged relation durations,
    interpolated boxes, adjacency, and the train split's truncation."""
    cfg = synthetic_raw.write_synthetic_vidvrd(str(tmp_path), 2, split,
                                               "pku")
    for name in sorted(os.listdir(os.path.join(cfg["ann_dir"], split))):
        with open(os.path.join(cfg["ann_dir"], split, name)) as f:
            anno = json.load(f)
        got = parse.parse_gt_annotation(
            name, anno, categories.vidvrd_CatName2Id,
            categories.vidvrd_PredName2Id, max_preds=max_preds,
            truncate=split == "train")
        _same_tree(got, jax_parse.parse_gt_annotation(
            name, anno, jax_cats.vidvrd_CatName2Id,
            jax_cats.vidvrd_PredName2Id, max_preds=max_preds,
            truncate=split == "train"))


def test_gt_annotation_rejects_a_relation_outside_its_trajectories():
    anno = {"trajectories": [[{"tid": 0, "bbox": dict(
        xmin=0, ymin=0, xmax=1, ymax=1)}]] + [[]] * 4,
        "width": 4, "height": 3,
        "subject/objects": [{"tid": 0, "category": "dog"}],
        "relation_instances": [{"subject_tid": 0, "object_tid": 0,
                                "predicate": "faster", "begin_fid": 2,
                                "end_fid": 4}]}
    with pytest.raises(ValueError, match="overlaps no"):
        parse.parse_gt_annotation("v", anno, categories.vidvrd_CatName2Id,
                                  categories.vidvrd_PredName2Id)


def test_interpolation_matches_jax():
    rng = np.random.default_rng(0)
    frames = np.array([3, 4, 7, 8, 12, 13, 14, 20])
    vec = rng.normal(size=(frames.size, 5))
    np.testing.assert_array_equal(
        interpolate.linear_interpolation(vec, frames),
        jax_interp.linear_interpolation(vec, frames))
    np.testing.assert_array_equal(
        interpolate.linear_interpolation(vec, frames.astype(float)),
        jax_interp.linear_interpolation(vec, frames.astype(float)))
    a = rng.normal(size=(9, 3))
    a[[0, 4, 8]] = 0
    b = a.copy()
    interpolate.fill_zeropadding(a)
    jax_interp.fill_zeropadding(b)
    np.testing.assert_array_equal(a, b)


def test_duration_helpers_match_jax():
    durs = [(30, 60), (0, 30), (45, 50), (70, 80), (80, 95), (100, 101)]
    assert temporal.merge_duration_list(durs) == \
        jax_temporal.merge_duration_list(durs)
    for a, b in [((0, 5), (5, 9)), ((0, 6), (5, 9)), ((3, 4), (0, 9))]:
        assert temporal.is_overlap(a, b) == jax_temporal.is_overlap(a, b)
    with pytest.raises(ValueError, match="empty"):
        temporal.is_overlap((3, 3), (0, 9))
