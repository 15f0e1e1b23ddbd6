"""The port's batch path against the JAX package's and against its plain
versions: the packer library (built here with g++) against numpy,
``bucketed_batches(iter_shuffled(dataset, seed))`` byte-identical to JAX's
for float32, bfloat16 and int8 wires (unstaged and packed into a staging
ring), ``prefetch``, and the device record cache on the CPU device, all
exactly.  The staging ring's own tests are in test_torch_data_ring.py."""
import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

from vidsgg_big_tpu.data import bucketing as jax_bucketing
from vidsgg_big_tpu.data.dataset import VidVRDDataset as JaxVidVRDDataset

from vidsgg_big_tpu_torch.data import bucketing, native, synthetic_raw
from vidsgg_big_tpu_torch.data.dataset import VidVRDDataset
from vidsgg_big_tpu_torch.data.device_cache import (DeviceRecordCache,
                                                    cached_or_host_epoch,
                                                    make_cache)
from vidsgg_big_tpu_torch.data.prefetch import prefetch
from vidsgg_big_tpu_torch.data.transfer import (StagingRing, tree_leaves,
                                                wire_feats)
from vidsgg_big_tpu_torch.data.types import pad_pack
from vidsgg_big_tpu_torch.ops import build
from vidsgg_big_tpu_torch.ops.segments import stretch_index_np

N_VIDEOS, FEAT = 7, 80


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A pku_i3d train split, and the dataset config of each package (own
    cache directories)."""
    root = tmp_path_factory.mktemp("split")
    cfg = synthetic_raw.write_synthetic_vidvrd(str(root), N_VIDEOS, "train",
                                               "pku_i3d", seed=4)
    return (dict(cfg, cache_dir=str(root / "cache_port")),
            dict(cfg, cache_dir=str(root / "cache_jax")))


# ---- the packer library ---------------------------------------------------

def test_packer_stretch_index_matches_numpy():
    lengths = np.array([0, 1, 3, 7, 64, 65, 200], np.int32)
    for t in (1, 8, 64, 256):
        np.testing.assert_array_equal(native.stretch_index(lengths, t),
                                      stretch_index_np(lengths, t))


def test_packer_pad_and_stretch_pack_match_numpy():
    """The library's pad_pack / stretch_pack (one contiguous source
    buffer) against the numpy packing and the numpy stretch gather."""
    rng = np.random.default_rng(0)
    trajs = [rng.normal(size=(n, 5)).astype(np.float32)
             for n in (1, 4, 9, 13)]
    src = np.ascontiguousarray(np.concatenate(trajs))
    lengths = np.asarray([x.shape[0] for x in trajs], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    lib = native.load()
    for t in (4, 16):
        got = np.zeros((6, t, 5), np.float32)
        lib.pad_pack(src, offsets, lengths, len(trajs), t, 5, got)
        np.testing.assert_array_equal(got, pad_pack(trajs, 6, t))
        got = np.zeros((6, t, 5), np.float32)
        lib.stretch_pack(src, offsets, lengths, len(trajs), t, 5, got)
        idx = stretch_index_np(lengths, t)
        for i, x in enumerate(trajs):
            np.testing.assert_array_equal(got[i], x[np.minimum(
                idx[i], x.shape[0] - 1)])
        assert not got[len(trajs):].any()


@pytest.mark.parametrize("rows", [300, 1, 0])
def test_packer_groups_rows_as_numpy(rows):
    rng = np.random.default_rng(rows)
    arr = np.c_[rng.integers(0, 90, rows), rng.integers(0, 13, rows),
                rng.normal(size=(rows, 4))]
    for got, want in zip(native.group_tracklet_rows(arr),
                         native.group_tracklet_rows_np(arr)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="max_trajs"):
        native.group_tracklet_rows(np.c_[np.zeros(3), np.arange(3)], 2)


def test_packer_build_failure_raises(tmp_path, monkeypatch):
    """A source the compiler rejects raises with the compiler's output; a
    missing compiler raises too: nothing falls back to numpy."""
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(build.HOST_LIBRARIES, "packer", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_host("packer")
    with pytest.raises(RuntimeError, match="cannot run"):
        build.build_host("packer", compiler="no-such-compiler-here")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="failed"):
        native.group_tracklet_rows(np.zeros((2, 12)))


# ---- bucketed batches against the JAX package ------------------------------

def _bits(x):
    """A leaf's bytes as a numpy array (bfloat16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _port_batches(cfg, dtype, staged, seed=3, **kw):
    ds = VidVRDDataset(**cfg)
    ring = StagingRing("cpu") if staged else None
    random.seed(0)
    for key, rows, props, gts in bucketing.bucketed_batches(
            bucketing.iter_shuffled(ds, seed), bucketing.BucketSpec(
                feat_dim=FEAT, feat_dtype=dtype, g_bucket=4), 2,
            staging=ring, **kw):
        if staged:
            props, gts = ring.ship((props, gts))
        else:
            props = props.replace(feats=wire_feats(props.feats,
                                                   getattr(torch, dtype)))
        yield key, [r[0].video_name for r in rows], props, gts


def _jax_batches(cfg, dtype, seed=3, **kw):
    ds = JaxVidVRDDataset(**cfg)
    random.seed(0)
    for key, rows, props, gts in jax_bucketing.bucketed_batches(
            jax_bucketing.iter_shuffled(ds, seed), jax_bucketing.BucketSpec(
                feat_dim=FEAT, feat_dtype=dtype, g_bucket=4), 2, **kw):
        yield key, [r[0].video_name for r in rows], props, gts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("staged", [False, True], ids=["numpy", "staged"])
@pytest.mark.parametrize("opts", [
    {}, dict(max_pending=3), dict(max_pending=3, drop_last=True),
    dict(shuffle=True, seed=5)], ids=["default", "early_flush", "drop_last",
                                      "shuffle"])
def test_bucketed_batches_byte_identical_to_jax(split, dtype, staged, opts):
    port_cfg, jax_cfg = split
    port = list(_port_batches(port_cfg, dtype, staged, **opts))
    want = list(_jax_batches(jax_cfg, dtype, **opts))
    assert len(port) == len(want) > 0
    for (pk, pn, pp, pg), (jk, jn, jp, jg) in zip(port, want):
        assert pk == jk and pn == jn
        for f in dataclasses.fields(pp):
            a, b = _bits(getattr(pp, f.name)), _bits(getattr(jp, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        for f in dataclasses.fields(pg):
            np.testing.assert_array_equal(_bits(getattr(pg, f.name)),
                                          _bits(getattr(jg, f.name)),
                                          err_msg=f.name)


def test_stream_buckets_matches_jax():
    rng = np.random.default_rng(2)
    items = [int(k) for k in rng.integers(0, 4, 40)]
    for kw in ({}, dict(max_pending=5), dict(max_pending=5, drop_last=True),
               dict(drop_last=True)):
        got = list(bucketing.stream_buckets(iter(items), lambda k: k, 3,
                                            **kw))
        assert got == list(jax_bucketing.stream_buckets(
            iter(items), lambda k: k, 3, **kw))


def test_iter_shuffled_map_fn_matches_jax():
    data = list(range(9))
    assert list(bucketing.iter_shuffled(data, 4, map_fn=str)) == \
        list(jax_bucketing.iter_shuffled(data, 4, map_fn=str))


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_keeps_order_and_raises_producer_errors():
    assert list(prefetch(iter(range(50)), size=2)) == list(range(50))

    def broken():
        yield 1
        raise KeyError("in the producer")

    got = []
    with pytest.raises(KeyError, match="in the producer"):
        for x in prefetch(broken()):
            got.append(x)
    assert got == [1]


def test_prefetch_releases_an_abandoned_producer():
    closed = threading.Event()

    def source():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    before = threading.active_count()
    gen = prefetch(source(), size=1)
    assert next(gen) == 0
    gen.close()
    assert closed.wait(5), "the producer never left its loop"
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# ---- the device record cache ------------------------------------------------

def _ship_epoch(ds, spec, bs, ring, cache, seed):
    out = []
    random.seed(0)
    for key, rows, props, gts in bucketing.bucketed_batches(
            bucketing.iter_shuffled(ds, seed), spec, bs, staging=ring):
        props, gts = ring.ship((props, gts))
        cache.offer(key, rows, props, gts)
        out.append((key, [r[0].video_name for r in rows], props, gts))
    return out


def _same_batch(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_epochs_bit_equal_to_the_host_path(split, dtype):
    ds = VidVRDDataset(**split[0])
    spec = bucketing.BucketSpec(feat_dim=FEAT, g_bucket=32, feat_dtype=dtype)
    ring = StagingRing("cpu")
    cache = DeviceRecordCache(ds.video_name_list, 2, 1e9)
    _ship_epoch(ds, spec, 2, ring, cache, seed=0)
    assert cache.complete and cache.bytes > 0
    for seed in (1, 3):
        host = _ship_epoch(ds, spec, 2, ring, DeviceRecordCache([], 2, 0),
                           seed)
        cached = list(cache.epoch_descriptors(seed))
        assert [(k, n) for k, n, _, _ in host] == cached
        for (_, _, hp, hg), (ck, names) in zip(host, cached):
            cp, cg = cache.assemble(ck, names)
            _same_batch((cp, cg), (hp, hg))


def test_skip_names_are_not_required(split):
    ds = VidVRDDataset(**split[0])
    spec = bucketing.BucketSpec(feat_dim=FEAT, g_bucket=32)
    skip = {ds.video_name_list[2]}
    cache = DeviceRecordCache(ds.video_name_list, 2, 1e9, skip_names=skip)
    assert ds.video_name_list[2] not in cache.required
    ring = StagingRing("cpu")
    random.seed(0)
    for key, rows, props, gts in bucketing.bucketed_batches(
            (ds.get_data(n) for n in cache.required), spec, 2,
            staging=ring):
        cache.offer(key, rows, *ring.ship((props, gts)))
    assert cache.complete
    random.seed(1)
    names = [n for _, ns in cache.epoch_descriptors(0) for n in ns]
    assert len(names) == N_VIDEOS and not skip & set(names)


def test_over_budget_frees_the_captured_records(split):
    """The JAX cache keeps what it captured when its budget runs out; the
    port frees it and stays on the host path."""
    ds = VidVRDDataset(**split[0])
    spec = bucketing.BucketSpec(feat_dim=FEAT, g_bucket=32)
    ring = StagingRing("cpu")
    full = DeviceRecordCache(ds.video_name_list, 2, 1e9)
    _ship_epoch(ds, spec, 2, ring, full, seed=0)
    per_video = full.bytes / N_VIDEOS
    cache = DeviceRecordCache(ds.video_name_list, 2, 3.5 * per_video)
    captured = []
    for key, rows, props, gts in bucketing.bucketed_batches(
            bucketing.iter_shuffled(ds, 0), spec, 2, staging=ring):
        cache.offer(key, rows, *ring.ship((props, gts)))
        captured.append(len(cache.records))
    assert captured[0] == 2 and cache.bytes == 0   # held, then freed
    assert cache.over_budget and not cache.complete
    assert cache.records == {} and cache.keys == {} and cache.bytes == 0


def test_an_incomplete_cache_is_dropped_after_a_full_host_epoch(split):
    """A video that never surfaces (here: never offered) keeps the cache
    incomplete; the next epoch drops it and its records.  A resumed partial
    first epoch (skip > 0) does not count as full."""
    ds = VidVRDDataset(**split[0])
    cache = DeviceRecordCache(ds.video_name_list, 2, 1e9)
    calls = []

    def host():
        calls.append(1)
        return iter(())

    cached_or_host_epoch(cache, 0, None, host, skip=3)
    assert not cache.saw_full_host_epoch
    cached_or_host_epoch(cache, 1, None, host)
    assert cache.saw_full_host_epoch and not cache.dropped
    cache.records["x"], cache.bytes = (None, None), 7
    cached_or_host_epoch(cache, 2, None, host)
    assert cache.dropped and cache.records == {} and cache.bytes == 0
    assert len(calls) == 3
    cache.offer(None, [], None, None)
    assert not cache.complete


def test_make_cache_is_off_under_a_mesh_and_at_zero(split):
    ds = VidVRDDataset(**split[0])

    class Args:
        device_cache_gb = 4.0

    assert make_cache(Args, ds, 2).budget == 4e9
    assert make_cache(Args, ds, 2, mesh=object()) is None
    Args.device_cache_gb = 0
    assert make_cache(Args, ds, 2) is None
    Args.device_cache_gb = 1.0
    assert make_cache(Args, list(range(3)), 2) is None
