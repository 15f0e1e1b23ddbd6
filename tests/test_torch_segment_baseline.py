"""The port's segment baseline against the JAX package's, on the CPU.

Association (host numpy), the model, its top-k cube and train step, the
segment store's synthetic writer and the CLI in both directions through one
weights file.  Inputs come from numpy seeds; tolerances are stated at each
comparison.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vidsgg_big_tpu.data import segment_store as jax_store
from vidsgg_big_tpu.evaluation import association as jax_assoc
from vidsgg_big_tpu.models import segment_baseline as jax_sb
from vidsgg_big_tpu_torch.data import segment_store
from vidsgg_big_tpu_torch.evaluation import association
from vidsgg_big_tpu_torch.models import segment_baseline as sb
from vidsgg_big_tpu_torch.models.transplant import (
    segment_baseline_state_dict_from_jax)
from vidsgg_big_tpu_torch.tools import segment_baseline as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(feature_dim=2 * 6 + 11 * 16, num_obj_cats=6, num_pred_cats=8,
             block_size=16)


def jax_cli():
    """The JAX package's tools/segment_baseline.py, imported as its tests
    import tools (its sibling ``common`` on the path while it loads)."""
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_segment_baseline",
            os.path.join(tools, "segment_baseline.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


def _boxes(rng, n, t):
    lt = rng.uniform(0, 100, (n, t, 2))
    return np.concatenate([lt, lt + rng.uniform(5, 60, (n, t, 2))], -1)


# ---- association ----------------------------------------------------------

def test_segments_and_cubic_iou_equal_jax():
    """segment_video and signatures equal; cubic IoU bit-equal (the same
    float64 numpy arithmetic)."""
    for fs, fe in ((0, 29), (0, 30), (0, 137), (10, 70), (3, 200)):
        assert association.segment_video(fs, fe) == \
            jax_assoc.segment_video(fs, fe)
        assert association.get_segment_signature("v", fs, fe) == \
            jax_assoc.get_segment_signature("v", fs, fe)
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 5, 9), _boxes(rng, 4, 9)
    b2[0] = b1[0]
    np.testing.assert_array_equal(association.cubic_iou(b1, b2),
                                  jax_assoc.cubic_iou(b1, b2))


def test_windowed_iou_and_merge_equal_jax():
    """Random trajectories at random offsets, the later one ending no
    earlier (the association's continuations): windowed IoU bit-equal, and
    merges give equal windows and boxes."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        s1, n1 = (int(x) for x in rng.integers(10, 40, 2))
        s2 = s1 + int(rng.integers(0, 50))
        n2 = max(s1 + n1 - s2, 0) + int(rng.integers(1, 30))
        r1, r2 = _boxes(rng, 1, n1)[0], _boxes(rng, 1, n2)[0]
        pairs = [(mod.Trajectory(s1, s1 + n1, r1.copy()),
                  mod.Trajectory(s2, s2 + n2, r2.copy()))
                 for mod in (association, jax_assoc)]
        assert association.traj_iou_windowed(*pairs[0]) == \
            jax_assoc.traj_iou_windowed(*pairs[1])
        assert association.traj_iou_windowed(*pairs[0][::-1]) == \
            jax_assoc.traj_iou_windowed(*pairs[1][::-1])
        a, b = pairs[0]
        if a.pend > b.pstart:
            got = association.merge_trajs(*pairs[0])
            want = jax_assoc.merge_trajs(*pairs[1])
            assert (got.pstart, got.pend) == (want.pstart, want.pend)
            np.testing.assert_array_equal(got.rois, want.rois)


def _association_inputs(seed):
    """Three videos of 4-7 segments, 5 trajectories a segment that drift
    slowly (so continuations overlap) or jump (so merges fail), and
    predictions over a few triplets with repeated scores."""
    rng = np.random.default_rng(seed)
    st, lookup = [], {}
    for v in range(3):
        vid = f"v{v}"
        segs = association.segment_video(0, 30 + 15 * int(rng.integers(3, 7)))
        base = _boxes(rng, 5, 1)[:, 0]
        for fs, fe in segs:
            jump = rng.uniform(0, 1, 5) < 0.3
            drift = rng.normal(0, 0.5, (5, 30, 4)).cumsum(1)
            rois = base[:, None] + drift + jump[:, None, None] * 80.0
            lookup[(vid, fs, fe)] = rois
            preds = []
            for _ in range(int(rng.integers(3, 12))):
                trip = tuple(int(x) for x in rng.integers(0, 2, 3))
                s, o = rng.choice(3, 2, replace=False)
                score = float(rng.choice([0.5, 0.25, rng.uniform()]))
                preds.append((score, trip, (int(s), int(o))))
            st.append(((vid, fs, fe), preds))
    rng.shuffle(st)
    return st, lookup


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_association_equals_jax(seed):
    """Equal video relations, in order, from predictions with merges,
    failed merges and tied scores; scores to 1e-12 (the same numpy means).
    The prediction cap (max_traj_num_in_clip) cuts the larger segments."""
    st, rois = _association_inputs(seed)
    names = [f"o{i}" for i in range(3)], [f"p{i}" for i in range(3)]
    outs = []
    for mod in (association, jax_assoc):
        lookup = {k: [mod.Trajectory(k[1], k[2], r) for r in v]
                  for k, v in rois.items()}
        per_video = {}
        for key, preds in st:
            per_video.setdefault(key[0], []).append((key, preds))
        outs.append({vid: mod.greedy_relational_association(
            rels, lookup, *names, max_traj_num_in_clip=8)
            for vid, rels in sorted(per_video.items())})
    got, want = outs
    assert got.keys() == want.keys()
    n_merged = 0
    for vid in got:
        assert len(got[vid]) == len(want[vid])
        for g, w in zip(got[vid], want[vid]):
            assert abs(g["score"] - w["score"]) <= 1e-12
            assert {k: v for k, v in g.items() if k != "score"} == \
                {k: v for k, v in w.items() if k != "score"}
            n_merged += g["duration"][1] - g["duration"][0] > 30
    assert n_merged > 0
    assert any(r["score"] == 1.0 for rels in got.values() for r in rels)


# ---- model ----------------------------------------------------------------

def _cfg(**kw):
    return (sb.SegmentBaselineConfig(**dict(SMALL, **kw)),
            jax_sb.SegmentBaselineConfig(**dict(SMALL, **kw)))


def _jax_params(jcfg, feats, seed=0):
    model = jax_sb.SegmentBaseline(jcfg)
    return model, model.init(jax.random.PRNGKey(seed), jnp.asarray(feats))


def _port_model(cfg, params):
    model = sb.SegmentBaseline(cfg)
    model.load_state_dict(segment_baseline_state_dict_from_jax(params),
                          strict=True)
    return model


def test_feature_preprocess_equals_jax():
    cfg, jcfg = _cfg()
    rng = np.random.default_rng(1)
    f = rng.uniform(0, 2, (7, cfg.feature_dim)).astype(np.float32)
    f[3, 12: 12 + 16] = 0.0
    np.testing.assert_array_equal(sb.feature_preprocess(f, cfg),
                                  jax_sb.feature_preprocess(f, jcfg))


def test_loss_and_log_softmax_equal_jax():
    """triplet_log_softmax and the masked baseline_loss within 1e-6, from
    JAX's weights carried across."""
    cfg, jcfg = _cfg()
    rng = np.random.default_rng(2)
    feats = np.abs(rng.normal(0.1, 0.3, (9, cfg.feature_dim))).astype(
        np.float32)
    trips = np.asarray([(0, 1, 2), (3, 4, 5), (2, 0, 1), (1, 7, 0)])
    labels = rng.integers(0, len(trips), 9)
    valid = np.arange(9) < 7
    jmodel, params = _jax_params(jcfg, feats)
    model = _port_model(cfg, params)
    want = jax_sb.triplet_log_softmax(
        jmodel.apply(params, jnp.asarray(feats)), feats[:, :6],
        feats[:, 6:12], jnp.asarray(trips))
    ft, tt = torch.from_numpy(feats), torch.from_numpy(trips)
    with torch.no_grad():
        got = sb.triplet_log_softmax(model(ft), ft[:, :6], ft[:, 6:12], tt)
        loss = sb.baseline_loss(model, ft, torch.from_numpy(labels),
                                torch.from_numpy(valid), tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    jloss = jax_sb.baseline_loss(params, jmodel, jnp.asarray(feats),
                                 jnp.asarray(labels), jnp.asarray(valid),
                                 jnp.asarray(trips))
    assert abs(float(loss) - float(jloss)) <= 1e-6


def _predict_both(cfg, jcfg, feats, valid, params):
    jmodel = jax_sb.SegmentBaseline(jcfg)
    js, jsto = jax_sb.predict_segment_pairs(
        params, jmodel, jnp.asarray(feats), jnp.asarray(valid))
    model = _port_model(cfg, params)
    s, sto = sb.predict_segment_pairs(model, torch.from_numpy(feats),
                                      torch.from_numpy(valid))
    return (s.numpy(), sto.numpy()), (np.asarray(js), np.asarray(jsto))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_predict_segment_pairs_equals_jax(ties):
    """Ids and pair rows equal, scores within 1e-6, padded rows -inf.  With
    ties: repeated classeme values, two predicate columns of equal weights
    and two equal pair rows, so every top-k meets equal values and only
    jax.lax.top_k's order (the lower index first) decides."""
    cfg, jcfg = _cfg(pair_topk=3, seg_topk=14)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(8, cfg.feature_dim)).astype(np.float32)
    for lo in (0, 6):       # the two classemes: probabilities, as stored
        c = np.abs(feats[:, lo:lo + 6])
        feats[:, lo:lo + 6] = c / c.sum(-1, keepdims=True)
    valid = np.arange(8) < 6
    _, params = _jax_params(jcfg, feats)
    if ties:                # dyadic classemes: exact products, exact ties
        feats[:, :12] = np.round(feats[:, :12] * 8) / 8 + 0.125
        kernel = np.array(params["params"]["pred_fc"]["kernel"])
        kernel[:, 5] = kernel[:, 2]
        kernel[:, 6] = kernel[:, 2]
        params = {"params": {"pred_fc": {
            "kernel": jnp.asarray(kernel),
            "bias": params["params"]["pred_fc"]["bias"]}}}
        feats[4] = feats[1]
    (s, sto), (js, jsto) = _predict_both(cfg, jcfg, feats, valid, params)
    np.testing.assert_array_equal(sto, jsto)
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(js))
    fin = np.isfinite(s)
    np.testing.assert_allclose(s[fin], js[fin], rtol=0, atol=1e-6)
    if ties:
        assert len(np.unique(s[fin])) < fin.sum()


def test_sample_positive_pairs_equals_jax():
    """The same samples from the same seed: a store segment's pairs, IoU
    and GT instances, sampled three times from one Generator each."""
    rng = np.random.default_rng(4)
    n = 9
    pairs = np.asarray([(i, j) for i in range(n) for j in range(n) if i != j])
    iou = rng.uniform(0, 1, (n, n)).astype(np.float32)
    trackid = np.asarray([-1] * 6 + [0, 1, 2])
    gt = [(0, 1, 2, 4, 1), (1, 2, 0, 3, 5), (2, 0, 1, 1, 1), (0, 2, 9, 9, 9)]
    tindex = {(2, 4, 1): 0, (0, 3, 5): 1, (1, 1, 1): 2}
    got_rng, want_rng = (np.random.default_rng(7) for _ in range(2))
    for sample_num in (3, 5, 100):
        got = sb.sample_positive_pairs(pairs, iou, trackid, gt, got_rng,
                                       sample_num, tindex)
        want = jax_sb.sample_positive_pairs(pairs, iou, trackid, gt,
                                            want_rng, sample_num, tindex)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) > 0


def _learnable_batch(cfg, n=64, seed=3):
    """The JAX test's learnable batch: classemes and a predicate signature
    channel encode the label's triplet."""
    rng = np.random.default_rng(seed)
    trips = np.asarray([(0, 1, 2), (3, 4, 5), (2, 0, 1), (1, 7, 0)])
    labels = rng.integers(0, len(trips), n)
    feats = np.abs(rng.normal(0.1, 0.2, (n, cfg.feature_dim))).astype(
        np.float32)
    for i, lab in enumerate(labels):
        s, p, o = trips[lab]
        feats[i, s] = 1.0
        feats[i, 6 + o] = 1.0
        feats[i, 2 * 6 + 8 * 16 + p] = 3.0
    return feats, labels, trips


def test_train_steps_equal_jax():
    """Twenty steps of the port's step (torch.optim.Adam at its defaults)
    and of JAX's (optax.adam), from JAX's first weights: losses and weights
    within 1e-5."""
    cfg, jcfg = _cfg()
    feats, labels, trips = _learnable_batch(cfg)
    jmodel, params = _jax_params(jcfg, feats)
    model = _port_model(cfg, params)
    tx = optax.adam(cfg.learning_rate)
    opt_state = tx.init(params)
    jstep = jax_sb.build_baseline_train_step(jmodel, tx)
    step = sb.build_baseline_train_step(
        model, torch.optim.Adam(model.parameters(), lr=cfg.learning_rate))
    args = (torch.from_numpy(feats), torch.from_numpy(labels),
            torch.ones(len(labels), dtype=torch.bool), torch.from_numpy(trips))
    jargs = (jnp.asarray(feats), jnp.asarray(labels),
             jnp.ones((len(labels),), bool), jnp.asarray(trips))
    for _ in range(20):
        loss = float(step(*args))
        params, opt_state, jloss = jstep(params, opt_state, *jargs)
        assert abs(loss - float(jloss)) <= 1e-5
    want = segment_baseline_state_dict_from_jax(params)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5)


def test_training_learns():
    """The JAX test's learning check on the port: at lr 1e-2 the loss halves
    in 60 steps and the triplet posterior names the label on 90%."""
    cfg, _ = _cfg()
    feats, labels, trips = _learnable_batch(cfg)
    model = sb.SegmentBaseline(cfg, generator=torch.Generator().manual_seed(0))
    step = sb.build_baseline_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2))
    f, lab = torch.from_numpy(feats), torch.from_numpy(labels)
    v, t = torch.ones(len(labels), dtype=torch.bool), torch.from_numpy(trips)
    with torch.no_grad():
        first = float(sb.baseline_loss(model, f, lab, v, t))
    for _ in range(60):
        loss = step(f, lab, v, t)
    assert float(loss) < first * 0.5
    with torch.no_grad():
        lp = sb.triplet_log_softmax(model(f), f[:, :6], f[:, 6:12], t)
    assert (lp.argmax(-1).numpy() == labels).mean() > 0.9


# ---- the segment store ----------------------------------------------------

def test_synthetic_store_equals_jax(tmp_path):
    """One seed and config: equal index, config and GT JSON, equal arrays in
    every segment file, and equal observed training triplets."""
    cfg, jcfg = _cfg(pair_topk=5, seg_topk=60)
    segment_store.write_synthetic_segments(str(tmp_path / "port"), 3, 2,
                                           seed=5, cfg=cfg)
    jax_store.write_synthetic_segments(str(tmp_path / "jax"), 3, 2, seed=5,
                                       cfg=jcfg)
    for name in ("index.json", "config.json", "gt.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    port = segment_store.SegmentStore(str(tmp_path / "port"))
    jax_s = jax_store.SegmentStore(str(tmp_path / "jax"))
    assert port.splits() == jax_s.splits() == ["test", "train"]
    for split in port.splits():
        assert port.segments(split) == jax_s.segments(split)
        for key in port.segments(split):
            got, want = port.load(*key), jax_s.load(*key)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(port.observed_train_triplets(),
                                  jax_s.observed_train_triplets())
    assert len(port.observed_train_triplets()) > 0
    # the default (small) writer config too
    segment_store.write_synthetic_segments(str(tmp_path / "p2"), 2, 1)
    jax_store.write_synthetic_segments(str(tmp_path / "j2"), 2, 1)
    assert (tmp_path / "p2" / "gt.json").read_text() == \
        (tmp_path / "j2" / "gt.json").read_text()


# ---- the CLI, both directions ---------------------------------------------

def _run_jax_cli(monkeypatch, argv):
    mod = jax_cli()
    monkeypatch.setattr(sys, "argv", ["segment_baseline.py"] + argv)
    mod.main()


def _relations(path):
    with open(path) as f:
        return json.load(f)["results"]


def _same_relations(got, want):
    """Equal videos and, in each, the same relations: triplets, durations
    and trajectories equal, scores within 1e-6.  The packages' linear
    layers sum in other orders, so two predictions of a segment whose
    scores lie within one float32 rounding of each other may take the
    association's score sort in either order; the relations are compared
    in an order of their own (triplet, duration, trajectories)."""
    def key(r):
        return json.dumps([r["triplet"], r["duration"], r["sub_traj"],
                           r["obj_traj"]])

    assert got.keys() == want.keys()
    for vid in want:
        assert len(got[vid]) == len(want[vid])
        for g, w in zip(sorted(got[vid], key=key), sorted(want[vid],
                                                          key=key)):
            assert key(g) == key(w)
            assert abs(g["score"] - w["score"]) <= 1e-6


def _metrics_line(path):
    with open(path) as f:
        return json.loads([ln for ln in f.read().splitlines()
                           if "detection_mAP" in ln][-1].split(" - ", 1)[1])


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segments") / "store")
    segment_store.write_synthetic_segments(root, n_videos=6)
    return root


def test_cli_detect_on_jax_weights_equals_jax(store_root, tmp_path,
                                              monkeypatch):
    """JAX's --train writes the weights; --detect of each package on that
    file writes equal relations and logs equal metrics."""
    monkeypatch.chdir(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _run_jax_cli(monkeypatch, ["--train", "--detect", "--data_root",
                               store_root, "--output_dir", str(jdir),
                               "--max_iter", "40"])
    os.makedirs(pdir)
    with open(jdir / sb.WEIGHTS_FILE, "rb") as f:
        (pdir / sb.WEIGHTS_FILE).write_bytes(f.read())
    out = port_cli.main(["--detect", "--data_root", store_root,
                         "--output_dir", str(pdir), "--device", "cpu"])
    name = "baseline_relation_prediction.json"
    _same_relations(_relations(pdir / name), _relations(jdir / name))
    assert out["detect"]["metrics"] == _metrics_line(tmp_path /
                                                     "segment_baseline")
    assert out["detect"]["n_relations"] > 0


def test_cli_port_weights_read_by_jax(store_root, tmp_path, monkeypatch):
    """The port's --train --device cpu writes JAX's file: JAX's --detect
    reads it and its relations and metrics equal the port's --detect."""
    monkeypatch.chdir(tmp_path)
    out = port_cli.main(["--train", "--detect", "--data_root", store_root,
                         "--output_dir", str(tmp_path / "port"),
                         "--max_iter", "40", "--device", "cpu"])
    losses = out["train"]["losses"]
    assert len(losses) == 40 and losses[-1] < losses[0]
    with np.load(tmp_path / "port" / sb.WEIGHTS_FILE) as w:
        assert w["kernel"].shape == (SMALL["feature_dim"],
                                     SMALL["num_pred_cats"])
        assert set(w.files) == {"kernel", "bias", "triplet_ids"}
    jdir = tmp_path / "jax"
    os.makedirs(jdir)
    with open(tmp_path / "port" / sb.WEIGHTS_FILE, "rb") as f:
        (jdir / sb.WEIGHTS_FILE).write_bytes(f.read())
    _run_jax_cli(monkeypatch, ["--detect", "--data_root", store_root,
                               "--output_dir", str(jdir)])
    name = "baseline_relation_prediction.json"
    _same_relations(_relations(tmp_path / "port" / name),
                    _relations(jdir / name))
    assert out["detect"]["metrics"] == _metrics_line(tmp_path /
                                                     "segment_baseline")
