"""The port's datasets, annotation APIs and preparation helpers against the
JAX package's on the same files: equal records (the train split's
redirects under one seeded global ``random``), each package reading the
other's ``.npz`` cache, the VidOR test split's video metadata, and equal
challenge GT, GloVe embeddings, bias matrix and classemes, exactly."""
import dataclasses
import json
import os
import random
import sys

import numpy as np
import pytest

from vidsgg_big_tpu.data import annotations as jax_annotations
from vidsgg_big_tpu.data import dataset as jax_dataset
from vidsgg_big_tpu.data import prepare as jax_prepare
from vidsgg_big_tpu.data import video_io as jax_video_io

from vidsgg_big_tpu_torch.data import (annotations, dataset, prepare,
                                       synthetic_raw, video_io)
from vidsgg_big_tpu_torch.data.synthetic import make_video
from vidsgg_big_tpu_torch.utils import categories

N_VIDEOS = 5


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _items(ds, seed):
    """Every item of ``ds`` in index order, the global ``random`` seeded
    (the train split's redirects draw from it)."""
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _drop_proposals(cfg, name, fmt):
    """Rewrite one video's tracklets so that no proposal survives (all
    background rows for pku, only 6-wide rows for vidor): the train split
    redirects away from it."""
    path = os.path.join(cfg["proposal_dir"], name + ".npy")
    rows = np.load(path)
    if fmt == "vidor":
        rows = rows[:, :6].copy()
    else:
        rows[:, 7] = 0
    np.save(path, rows)


@pytest.mark.parametrize("fmt", ["mega", "pku", "pku_i3d"])
def test_vidvrd_records_match_jax_and_read_each_others_cache(tmp_path, fmt):
    cfg = synthetic_raw.write_synthetic_vidvrd(str(tmp_path), N_VIDEOS,
                                               "train", fmt, seed=1)
    if fmt != "mega":
        _drop_proposals(cfg, "ILSVRC2015_synth_01000002", fmt)
    port_cfg = dict(cfg, cache_dir=str(tmp_path / "port"))
    jax_cfg = dict(cfg, cache_dir=str(tmp_path / "jax"))
    got = _items(dataset.VidVRDDataset(**port_cfg), 7)
    want = _items(jax_dataset.VidVRDDataset(**jax_cfg), 7)
    _same(got, want)
    if fmt != "mega":    # the empty video redirected in both packages
        assert "ILSVRC2015_synth_01000002" not in {p.video_name
                                                   for p, _ in got}
    # each package reads the other's per-video cache to equal records
    crossed = dataset.VidVRDDataset(**dict(cfg, cache_dir=str(
        tmp_path / "jax")))
    assert not crossed.seconds
    _same(_items(crossed, 7), want)
    assert crossed.seconds["load"][1] >= N_VIDEOS and \
        "parse" not in crossed.seconds
    _same(_items(jax_dataset.VidVRDDataset(**dict(cfg, cache_dir=str(
        tmp_path / "port"))), 7), want)


@pytest.mark.parametrize("split", ["train", "val"])
def test_vidor_records_match_jax_and_read_each_others_cache(tmp_path, split):
    cfg = synthetic_raw.write_synthetic_vidor(str(tmp_path), N_VIDEOS, split,
                                              seed=2)
    if split == "train":
        _drop_proposals(cfg, "0000_2000002002", "vidor")
    cfg.pop("video_dir")
    port = dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "p")))
    jax = jax_dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "j")))
    got, want = _items(port, 3), _items(jax, 3)
    _same(got, want)
    names = {item[1].video_name for item in got}
    assert ("0000_2000002002" in names) == (split == "val")
    for name in port.video_name_list:
        assert port.video_feature_len(name) == jax.video_feature_len(name)
    _same(_items(dataset.VidORDataset(**dict(
        cfg, cache_dir=str(tmp_path / "j"))), 3), want)
    _same(_items(jax_dataset.VidORDataset(**dict(
        cfg, cache_dir=str(tmp_path / "p"))), 3), want)


def test_vidor_proposal_shards_match_jax(tmp_path):
    """The train split reads its tracklets from 500-video shards: only the
    videos of the configured shards, each from its own directory."""
    cfg = synthetic_raw.write_synthetic_vidor(str(tmp_path), 3, "train",
                                              seed=0)
    cfg.pop("video_dir")
    cfg["proposal_dir"] = {0: cfg["proposal_dir"], 3: "/nonexistent"}
    port = dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "p")))
    jax = jax_dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "j")))
    assert port.video_name_list == jax.video_name_list
    assert [port._track_res_path(n) for n in port.video_name_list] == \
        [jax._track_res_path(n) for n in jax.video_name_list]


def test_vidor_test_split_reads_the_videos(tmp_path):
    """The annotation-free test split takes video_len and (w, h) from the
    video files (OpenCV), as JAX's."""
    pytest.importorskip("cv2")
    cfg = synthetic_raw.write_synthetic_vidor(str(tmp_path), 2, "test",
                                              video_len=24)
    port = dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "p")))
    jax = jax_dataset.VidORDataset(**dict(cfg, cache_dir=str(tmp_path / "j")))
    _same(_items(port, 0), _items(jax, 0))
    path = video_io.find_video_file(cfg["video_dir"], "0000", "2000000000")
    assert video_io.get_video_info(path) == \
        jax_video_io.get_video_info(path) == (24, (96, 64))


def test_reading_a_video_without_opencv_names_the_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        video_io.get_video_info("v.avi")


def test_vidor_test_split_needs_video_dir(tmp_path):
    cfg = synthetic_raw.write_synthetic_vidor(
        str(tmp_path), 1, "val", seed=0, with_video_features=False)
    cfg.update(split="test", video_dir=None)
    with pytest.raises(ValueError, match="video_dir"):
        dataset.VidORDataset(**cfg)


def test_merge_gt_into_proposals_matches_jax():
    prop, gt = make_video(3, feat_dim=8)
    feats = [np.full((b.shape[0], 8), i, np.float32)
             for i, b in enumerate(gt.traj_boxes)]
    for score_th in (None, 0.5):
        _same(dataset.merge_gt_into_proposals(prop, gt, feats, 6, score_th),
              jax_dataset.merge_gt_into_proposals(prop, gt, feats, 6,
                                                  score_th))


@pytest.mark.parametrize("which", ["vidvrd", "vidor"])
def test_annotation_dataset_and_challenge_gt_match_jax(tmp_path, which):
    if which == "vidvrd":
        cfg = synthetic_raw.write_synthetic_vidvrd(str(tmp_path), 3, "train",
                                                   "pku", seed=5)
        args = (cfg["ann_dir"], ["train"])
        port, jax = annotations.VidVRD(*args), jax_annotations.VidVRD(*args)
        split = "train"
    else:
        cfg = synthetic_raw.write_synthetic_vidor(str(tmp_path), 3, "val",
                                                  seed=5)
        args = (cfg["ann_dir"], ["validation"])
        port, jax = annotations.VidOR(*args), jax_annotations.VidOR(*args)
        split = "validation"
    assert port.soid2so == jax.soid2so and port.pid2pred == jax.pid2pred
    assert port.get_triplets(split) == jax.get_triplets(split)
    vid = port.get_index(split)[0]
    assert port.get_object_insts(vid) == jax.get_object_insts(vid)
    assert port.get_action_insts(vid) == jax.get_action_insts(vid)
    got = annotations.prepare_gts_for_eval(port, split,
                                           str(tmp_path / "gt.json"))
    assert got == jax_annotations.prepare_gts_for_eval(jax, split)
    with open(tmp_path / "gt.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    with pytest.raises(FileNotFoundError, match="no annotations"):
        type(port)(cfg["ann_dir"], ["nosuchsplit"])


def test_prepare_matches_jax(tmp_path):
    """GloVe parsing and name embeddings, triplet names, the bias matrix,
    classemes and logits: the JAX package's values."""
    rng = np.random.default_rng(0)
    words = sorted({w for n in categories.VIDVRD_ENTITIES
                    + categories.VIDVRD_PREDICATES
                    for part in n.split("(")[0].split("/")
                    for w in part.split("_")})
    glove_path = tmp_path / "glove.txt"
    with open(glove_path, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in
                                       rng.normal(size=8)) + "\n")
        f.write("bad line\n")
    glove = prepare.load_glove(str(glove_path), dim=8)
    jglove = jax_prepare.load_glove(str(glove_path), dim=8)
    assert glove.keys() == jglove.keys()
    names = ["__background__"] + categories.VIDVRD_PREDICATES[1:]
    np.testing.assert_array_equal(
        prepare.build_name_embeddings(names, glove, 8),
        jax_prepare.build_name_embeddings(names, jglove, 8))
    with pytest.raises(ValueError, match="1 to 3 words"):
        prepare.name_embedding("a_b_c_d", glove, 8)

    gts = [make_video(i)[1] for i in range(3)]
    e_names, p_names = categories.get_vocab("vidvrd")
    trips = prepare.collect_triplet_names(gts, e_names, p_names)
    assert trips == jax_prepare.collect_triplet_names(gts, e_names, p_names)
    np.testing.assert_array_equal(
        prepare.build_bias_matrix(trips, categories.vidvrd_CatName2Id,
                                  categories.vidvrd_PredName2Id),
        jax_prepare.build_bias_matrix(trips, categories.vidvrd_CatName2Id,
                                      categories.vidvrd_PredName2Id))
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_array_equal(prepare.extract_classeme(logits, emb),
                                  jax_prepare.extract_classeme(logits, emb))
    w, b = rng.normal(size=(5, 3)), rng.normal(size=5)
    feats = rng.normal(size=(4, 3))
    np.testing.assert_array_equal(prepare.extract_logits(feats, w, b),
                                  jax_prepare.extract_logits(feats, w, b))
