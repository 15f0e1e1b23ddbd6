"""The port's zero-shot, fraction-recall, trajectory-mAP and
action-detection metrics against the JAX package's on the same seeded
random GT and predictions (empty videos and tied scores included).  The
metrics run on the host in float64 / float32 numpy in both packages, so
the tolerance is equality."""
import numpy as np
import pytest

from vidsgg_big_tpu.data.types import VideoGTRecord as JaxGTRecord
from vidsgg_big_tpu.evaluation import action_detection as jax_ad
from vidsgg_big_tpu.evaluation import fraction_recall as jax_fr
from vidsgg_big_tpu.evaluation import traj_map as jax_tm
from vidsgg_big_tpu.evaluation import zero_shot as jax_zs

from vidsgg_big_tpu_torch.data import synthetic_raw
from vidsgg_big_tpu_torch.data.types import VideoGTRecord
from vidsgg_big_tpu_torch.evaluation import (action_detection,
                                             fraction_recall, traj_map,
                                             zero_shot)

NAMES = ("dog", "cat", "car", "person")
PREDS = ("chase", "ride", "next_to")


def _traj(rng, n):
    """n boxes near a random start box: xyxy ints as floats."""
    x0, y0 = rng.integers(0, 200, 2)
    w, h = rng.integers(20, 80, 2)
    jitter = rng.integers(-6, 7, (n, 4))
    base = np.array([x0, y0, x0 + w, y0 + h])
    return (base + jitter).astype(float).tolist()


def _near(rng, traj):
    return (np.asarray(traj) + rng.integers(-4, 5, (len(traj), 4))).tolist()


def _relations(seed, n_videos=6, with_scores=False, from_gt=None):
    """{vid: [relation dicts]}: video 0 empty; scores drawn from a few
    values so that many tie; predictions partly copy a GT relation."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in range(n_videos):
        vid = f"v{v}"
        rels = []
        n = 0 if v == 0 else int(rng.integers(1, 7))
        for _ in range(n):
            src = None
            if from_gt is not None and from_gt.get(vid) and rng.random() < .6:
                src = from_gt[vid][int(rng.integers(len(from_gt[vid])))]
            if src is not None:
                s, e = src["duration"]
                r = {"triplet": list(src["triplet"]), "duration": [s, e],
                     "sub_traj": _near(rng, src["sub_traj"]),
                     "obj_traj": _near(rng, src["obj_traj"])}
            else:
                s = int(rng.integers(0, 20))
                e = s + int(rng.integers(3, 15))
                r = {"triplet": [NAMES[rng.integers(4)],
                                 PREDS[rng.integers(3)],
                                 NAMES[rng.integers(4)]],
                     "duration": [s, e], "sub_traj": _traj(rng, e - s),
                     "obj_traj": _traj(rng, e - s)}
            if with_scores:
                r["score"] = float(rng.choice([0.9, 0.5, 0.5, 0.25]))
            rels.append(r)
        out[vid] = rels
    return out


@pytest.fixture(scope="module")
def rel_data():
    gt = _relations(0)
    pred = _relations(1, with_scores=True, from_gt=gt)
    pred["v_extra"] = _relations(2, 2, with_scores=True)["v1"]
    train = {("dog", "chase", "cat"), ("car", "ride", "person"),
             ("person", "next_to", "dog")}
    return gt, pred, train


@pytest.mark.parametrize("old", [False, True])
def test_evaluate_zero_shot_matches_jax(rel_data, old):
    gt, pred, train = rel_data
    got = zero_shot.evaluate_zero_shot(gt, pred, train,
                                       use_old_zeroshot_eval=old)
    want = jax_zs.evaluate_zero_shot(gt, pred, train,
                                     use_old_zeroshot_eval=old)
    assert got == want
    assert got[0] > 0


def test_collect_train_triplets_matches_jax(tmp_path):
    vrd = synthetic_raw.write_synthetic_vidvrd(str(tmp_path / "vrd"), 3,
                                               "train", seed=1)
    vor = synthetic_raw.write_synthetic_vidor(
        str(tmp_path / "vor"), 3, "train", seed=1, with_video_features=False)
    for kind, ann in (("vidvrd", vrd["ann_dir"]), ("vidor", vor["ann_dir"])):
        got = zero_shot.collect_train_triplets(kind, ann)
        assert got and got == jax_zs.collect_train_triplets(kind, ann)


def _gt_record(rng, name, n_trajs, n_preds, cls=VideoGTRecord):
    """A GT record whose predicates repeat some 5-tuples (multi-duration
    instances)."""
    cats = rng.integers(1, 5, n_trajs).astype(np.int32)
    pred_cats = rng.integers(1, 4, n_preds).astype(np.int32)
    adj = np.zeros((2, n_preds, n_trajs), np.float32)
    for p in range(n_preds):
        if p and rng.random() < 0.4:          # a repeat of the last tuple
            pred_cats[p] = pred_cats[p - 1]
            adj[:, p] = adj[:, p - 1]
            continue
        s, o = rng.choice(n_trajs, 2, replace=False) if n_trajs > 1 else \
            (0, 0)
        adj[0, p, s] = adj[1, p, o] = 1
    return cls(video_name=name, video_len=40, video_wh=(64, 48),
               traj_cat_ids=cats,
               traj_durations=np.zeros((n_trajs, 2), np.int32),
               traj_boxes=[np.zeros((3, 4), np.float32)] * n_trajs,
               pred_cat_ids=pred_cats,
               pred_durations=np.zeros((n_preds, 2), np.float32), adj=adj)


def test_fraction_recall_matches_jax():
    rng = np.random.default_rng(3)
    shapes = [(4, 6), (3, 0), (0, 0), (5, 9), (2, 5), (6, 12)]
    port, jax_recs, hit_infos = [], [], {}
    for v, (g, p) in enumerate(shapes):
        name = f"{v % 2:04d}_{1000 + v}"
        state = rng.bit_generator.state
        port.append(_gt_record(rng, name, g, p))
        rng.bit_generator.state = state
        jax_recs.append(_gt_record(rng, name, g, p, JaxGTRecord))
        if v != 4:        # a video the eval never saw
            ids = rng.choice([-1, -1, 0, 49, 50, 51, 100, 150, 151, 999,
                              1000, 1001], p)
            hit_infos[str(1000 + v)] = (rng.random(p), ids.astype(int))

    def reset(n):
        return n.split("_")[1]

    got = fraction_recall.fraction_recall(port, hit_infos, reset_name=reset)
    want = jax_fr.fraction_recall(jax_recs, hit_infos, reset_name=reset)
    assert got == want
    assert got["dataset_level"]["multiple"][1000] > 0
    for rec, jrec in zip(port, jax_recs):
        assert np.array_equal(fraction_recall.gt_5tuples(rec),
                              jax_fr.gt_5tuples(jrec))
    tuples = fraction_recall.gt_5tuples(port[-1])
    ids = rng.integers(-1, 200, tuples.shape[0])
    assert fraction_recall.calculate_n_hits(tuples, ids) == \
        jax_fr.calculate_n_hits(tuples, ids)
    assert fraction_recall.N_RECALLS == jax_fr.N_RECALLS


def _traj_dicts(seed, gt=None):
    """{vid: [{category, trajectory: {fid: box}, (score)}]}: video 0 empty,
    scores with ties; predictions near a GT trajectory or off it."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in range(5):
        tracks = []
        for _ in range(0 if v == 0 else int(rng.integers(1, 5))):
            if gt is not None and gt.get(f"v{v}") and rng.random() < 0.7:
                src = gt[f"v{v}"][int(rng.integers(len(gt[f"v{v}"])))]
                fids = sorted(src["trajectory"])
                keep = fids[int(rng.integers(0, 3)):]
                boxes = _near(rng, [src["trajectory"][f] for f in keep])
                d = {"category": src["category"],
                     "trajectory": dict(zip(keep, boxes))}
            else:
                s = int(rng.integers(0, 10))
                n = int(rng.integers(4, 12))
                d = {"category": NAMES[rng.integers(4)],
                     "trajectory": dict(zip(range(s, s + n),
                                            _traj(rng, n)))}
            if gt is not None:
                d["score"] = float(rng.choice([0.8, 0.8, 0.3]))
            tracks.append(d)
        out[f"v{v}"] = tracks
    return out


def test_eval_video_object_matches_jax():
    gt = _traj_dicts(4)
    pred = _traj_dicts(5, gt)
    pred["v_none"] = _traj_dicts(6, gt)["v1"]
    got = traj_map.eval_video_object(gt, pred)
    assert got == jax_tm.eval_video_object(gt, pred)
    assert 0 < got[0] < 1
    assert traj_map.eval_video_object(gt, pred, use_07_metric=False) == \
        jax_tm.eval_video_object(gt, pred, use_07_metric=False)
    some = gt["v1"][0]["trajectory"]
    assert traj_map.trajectory_overlap([some, some], some) == \
        jax_tm.trajectory_overlap([some, some], some) == (1.0, 0)


def test_eval_video_object_hits_at_the_threshold():
    """A prediction on one of two GT frames overlaps at exactly 0.5, the
    threshold, and counts as a hit in both packages."""
    box = [10.0, 10.0, 50.0, 40.0]
    gt = {"v": [{"category": "dog", "trajectory": {0: box, 1: box}}]}
    pred = {"v": [{"category": "dog", "score": 0.5,
                   "trajectory": {0: box}}]}
    assert traj_map.trajectory_overlap([gt["v"][0]["trajectory"]],
                                       pred["v"][0]["trajectory"]) == \
        (0.5, 0)
    got = traj_map.eval_video_object(gt, pred)
    assert got == jax_tm.eval_video_object(gt, pred) and got[0] > 0.99


def test_record_to_traj_dicts_matches_jax():
    rng = np.random.default_rng(7)
    durations = np.array([[0, 3], [2, 2], [5, 9]], np.int32)
    boxes = [rng.random((4, 4)).astype(np.float32) * 100,
             rng.random((1, 4)).astype(np.float32) * 100,
             rng.random((5, 4)).astype(np.float32) * 100]
    cats = np.array([1, 2, 3])
    id2name = {i: n for i, n in enumerate(("bg",) + NAMES)}
    scores = np.array([0.5, 0.25, 0.5], np.float32)
    assert traj_map.record_to_traj_dicts(cats, durations, boxes, id2name,
                                         scores) == \
        jax_tm.record_to_traj_dicts(cats, durations, boxes, id2name, scores)


def _actions(seed, gt=None):
    rng = np.random.default_rng(seed)
    out = {}
    for v in range(5):
        acts = []
        for _ in range(0 if v == 0 else int(rng.integers(1, 5))):
            if gt is not None and gt.get(f"v{v}") and rng.random() < 0.6:
                src = gt[f"v{v}"][int(rng.integers(len(gt[f"v{v}"])))]
                d = {"category": src["category"],
                     "duration": tuple(src["duration"]),
                     "trajectory": _near(rng, src["trajectory"])}
            else:
                s = int(rng.integers(0, 15))
                e = s + int(rng.integers(2, 10))
                d = {"category": PREDS[rng.integers(3)], "duration": (s, e),
                     "trajectory": _traj(rng, e - s)}
            if gt is not None:
                d["score"] = float(rng.choice([0.7, 0.7, 0.2]))
            acts.append(d)
        out[f"v{v}"] = acts
    return out


def test_eval_action_matches_jax():
    gt = _actions(8)
    pred = _actions(9, gt)
    pred["v_none"] = _actions(10, gt)["v2"]
    got = action_detection.eval_action(gt, pred)
    assert got == jax_ad.eval_action(gt, pred)
    assert 0 < got[0] < 1
    assert action_detection.eval_action({}, pred) == \
        jax_ad.eval_action({}, pred) == (0.0, [])
