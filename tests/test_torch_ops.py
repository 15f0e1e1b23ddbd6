"""The port's segment / temporal ops, record packing and bucketing against
the JAX package on the same numpy inputs: integer outputs equal, floats
within 1e-6."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vidsgg_big_tpu.data import bucketing as jax_bucketing
from vidsgg_big_tpu.data import synthetic as jax_synthetic
from vidsgg_big_tpu.data import types as jax_types
from vidsgg_big_tpu.ops import segments as jax_segments
from vidsgg_big_tpu.ops import temporal as jax_temporal

from vidsgg_big_tpu_torch.data import bucketing, synthetic, types
from vidsgg_big_tpu_torch.ops import segments, temporal


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("t", [7, 32, 64])
def test_stretch_index_np(t):
    lengths = np.array([0, 1, 3, 7, 31, 64, 90], np.int32)
    _eq(segments.stretch_index_np(lengths, t),
        jax_segments.stretch_index_np(lengths, t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stretch_conv_patches_bit_identical(dtype):
    """The port's gather equals the JAX one-hot matmul bit for bit."""
    rng = np.random.default_rng(0)
    n, t, d = 6, 32, 10
    x = rng.normal(size=(n, t, d)).astype(np.float32)
    idx = jax_segments.stretch_index_np(rng.integers(0, 40, n), t)
    _eq(segments.stretch_conv_src(_t(idx), t),
        jax_segments.stretch_conv_src(idx, t))
    want = jax_segments.stretch_conv_patches(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(idx))
    got = segments.stretch_conv_patches(_t(x).to(getattr(torch, dtype)),
                                        _t(idx))
    assert got.shape == want.shape
    _eq(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("length,out_len", [(32, 4), (30, 4), (7, 4)])
def test_adaptive_max_pool1d(length, out_len):
    x = np.random.default_rng(1).normal(size=(3, length, 5)).astype(
        np.float32)
    _eq(segments.adaptive_max_pool1d(_t(x), out_len, axis=-2),
        jax_segments.adaptive_max_pool1d(jnp.asarray(x), out_len, axis=-2))
    # and the reference op itself, channels first
    _eq(segments.adaptive_max_pool1d(_t(x), out_len, axis=-2),
        torch.nn.functional.adaptive_max_pool1d(
            _t(x).transpose(1, 2), out_len).transpose(1, 2))


def test_stretch_counts_and_weighted_mean():
    rng = np.random.default_rng(2)
    lengths = np.array([[1, 5, 16], [20, 3, 0]], np.int32)
    t = 16
    _eq(segments.stretch_counts(_t(lengths), t),
        jax_segments.stretch_counts(jnp.asarray(lengths), t))
    x = rng.normal(size=(2, 3, t, 4)).astype(np.float32)
    np.testing.assert_allclose(
        segments.stretch_weighted_mean(_t(x), _t(lengths)).numpy(),
        np.asarray(jax_segments.stretch_weighted_mean(
            jnp.asarray(x), jnp.asarray(lengths))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("limits", [(133, 36, 36, 50, 50),
                                    (133, 36, 36, 180, 180)])
def test_pack_rows(limits):
    rng = np.random.default_rng(3)
    rows = np.stack([rng.integers(0, lim, 64) for lim in limits], -1)
    got = segments.pack_rows(_t(rows), limits)
    want = jax_segments.pack_rows(jnp.asarray(rows), limits)
    assert got.dtype == torch.int32 and got.shape == want.shape
    _eq(got, want)


def _dedup_inputs(seed, m=300):
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, 3, m), rng.integers(0, 2, m),
                     rng.integers(0, 4, m)], -1)
    keys = np.asarray(jax_segments.pack_rows(jnp.asarray(rows),
                                             (1 << 20, 1 << 20, 4)))
    scores = rng.integers(0, 5, m).astype(np.float32)   # many score ties
    valid = rng.uniform(size=m) > 0.2
    return keys, scores, valid


@pytest.mark.parametrize("path", ["dense", "sort"])
@pytest.mark.parametrize("seed", [4, 5])
def test_unique_max(monkeypatch, path, seed):
    """Both the dense and the lexsort paths keep the JAX winners, score
    ties included (lowest index wins)."""
    keys, scores, valid = _dedup_inputs(seed)
    assert keys.shape[1] == 2                 # multi-word keys
    if path == "sort":
        monkeypatch.setattr(jax_segments, "_DENSE_DEDUP_MAX", 0)
        monkeypatch.setattr(segments, "DENSE_DEDUP_MAX", 0)
    want = jax_segments.unique_max(jnp.asarray(keys), jnp.asarray(scores),
                                   jnp.asarray(valid))
    got = segments.unique_max(_t(keys)[None], _t(scores)[None],
                              _t(valid)[None])[0]
    _eq(got, want)


def test_temporal_ops():
    rng = np.random.default_rng(6)
    s = rng.integers(0, 50, (2, 7))
    d = np.stack([s, s + rng.integers(0, 30, (2, 7))], -1).astype(np.int32)
    for b in range(2):
        inter, mask = temporal.dura_intersection(_t(d)[b], _t(d)[b])
        j_inter, j_mask = jax_temporal.dura_intersection(d[b], d[b])
        _eq(inter, j_inter)
        _eq(mask, j_mask)
        np.testing.assert_allclose(
            temporal.tiou(_t(d)[b], _t(d)[b]).numpy(),
            np.asarray(jax_temporal.tiou(jnp.asarray(d[b]),
                                         jnp.asarray(d[b]))), atol=1e-6)
    # batched form: one call over the leading axis
    inter, _ = temporal.dura_intersection(_t(d), _t(d))
    _eq(inter[1], jax_temporal.dura_intersection(d[1], d[1])[0])
    _eq(temporal.dura_intersection(_t(d[0]), _t(d[0]), broadcast=False)[0],
        jax_temporal.dura_intersection(d[0], d[0], broadcast=False)[0])


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_records_byte_identical(seed):
    kw = dict(video_len=60, n_gt_trajs=6, n_preds=8, n_distractors=6,
              feat_dim=24)
    for a, b in zip(synthetic.make_video(seed, **kw),
                    jax_synthetic.make_video(seed, **kw)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, list):
                assert len(x) == len(y)
                for xi, yi in zip(x, y):
                    assert xi.dtype == yi.dtype and xi.tobytes() == yi.tobytes()
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            else:
                assert x == y


def _leaves_equal(port_batch, jax_batch):
    for f in dataclasses.fields(port_batch):
        got = getattr(port_batch, f.name)
        want = np.asarray(getattr(jax_batch, f.name))
        assert got.dtype == want.dtype, f.name
        _eq(got, want)


def test_pack_proposal_and_stack_batches():
    props = [synthetic.make_video(s, video_len=70, feat_dim=24)[0]
             for s in range(3)]
    # a zero-proposal video, as real splits have
    props.append(dataclasses.replace(
        props[0], boxes=[], features=[], cat_ids=props[0].cat_ids[:0],
        scores=props[0].scores[:0], durations=props[0].durations[:0]))
    # T=64 truncates the longer tracklets, as the bucket does
    port = types.stack_batches([types.pack_proposal(p, 12, 64, 24)
                                for p in props])
    want = jax_types.stack_batches([jax_types.pack_proposal(p, 12, 64, 24)
                                    for p in props])
    _leaves_equal(port, want)
    dev = port.to("cpu", feats=torch.bfloat16)
    assert dev.feats.dtype == torch.bfloat16
    assert dev.traj_mask.dtype == torch.bool
    _eq(dev.stretch_idx, want.stretch_idx)


def test_pack_gt():
    gts = [synthetic.make_video(s, video_len=70, feat_dim=8)[1]
           for s in range(3)]
    port = types.stack_batches([types.pack_gt(g, 8, 64, 12) for g in gts])
    want = jax_types.stack_batches([jax_types.pack_gt(g, 8, 64, 12)
                                    for g in gts])
    _leaves_equal(port, want)


@pytest.mark.parametrize("with_gt", [False, True])
def test_bucketed_batches(with_gt):
    """Same keys, rows and leaves as the JAX bucketer, padded repeats
    masked out."""
    items = [synthetic.make_video(s, video_len=40 + 25 * (s % 3),
                                  feat_dim=16) for s in range(7)]
    got = list(bucketing.bucketed_batches(
        items, bucketing.BucketSpec(feat_dim=16), 3, with_gt=with_gt))
    want = list(jax_bucketing.bucketed_batches(
        items, jax_bucketing.BucketSpec(feat_dim=16), 3, with_gt=with_gt))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, rows, props, gts), (_, jrows, jprops, jgts) in zip(got, want):
        assert [r[0].video_name for r in rows] == \
            [r[0].video_name for r in jrows]
        _leaves_equal(props, jprops)
        assert (gts is None) == (jgts is None) == (not with_gt)
        if with_gt:
            _leaves_equal(gts, jgts)


@pytest.mark.parametrize("value", [1, 31, 32, 33, 200, 299, 1024, 1500, 5000])
def test_grounding_ladder_matches_jax(value):
    """pick_unbounded's default is the grounding ladder, as in JAX, and it
    doubles past the top instead of truncating."""
    assert bucketing.GROUNDING_LADDER == jax_bucketing.GROUNDING_LADDER
    assert bucketing.pick_unbounded(value) == \
        jax_bucketing.pick_unbounded(value) >= value


def test_vidor_synthetic_shapes():
    """VidOR-shaped records (81/51 categories, RoI + classeme channels, a
    two-part name) and I3D clip features of the JAX writer's shape
    (data/synthetic_raw.py:167), seeded."""
    prop, gt = synthetic.make_vidor_video(3, feat_dim=64 + 300,
                                          video_len=2400)
    assert prop.video_name == "synth_000003"
    assert len(prop.video_name.split("_")) == 2
    assert prop.features[0].shape[1] == 364
    assert prop.cat_ids.max() < 81 and gt.pred_cat_ids.max() < 51
    feats = synthetic.clip_features(3, 2400)
    assert feats.shape == (299, 1024) == (synthetic.num_clips(2400), 1024)
    np.testing.assert_array_equal(feats, synthetic.clip_features(3, 2400))
    assert synthetic.num_clips(20) == 2
