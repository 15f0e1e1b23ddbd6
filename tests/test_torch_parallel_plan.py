"""The port's multi-GPU pieces that need no second process: the
tensor-parallel plan against the JAX package's, the mesh flag, the sharded
random draws and the row-sharded batch packing.

The plan test runs JAX's ``param_partition_specs`` on the same models (BIG-C
v10, BIG-C v7, Base-C at the demo widths), marks every element of every
JAX leaf with the model shard (1 or 2) it lands in under a 2-way model
axis (0 where replicated), carries the marks into the port's names with
``transplant`` and holds them against the marks the port's own plan gives:
the same tensors split, along the same axis, the same elements to each
rank.
"""
import os

import numpy as np
import pytest
import torch

from vidsgg_big_tpu_torch.data.bucketing import BucketSpec, bucketed_batches
from vidsgg_big_tpu_torch.data.synthetic import make_video
from vidsgg_big_tpu_torch.data.transfer import StagingRing
from vidsgg_big_tpu_torch.models.base_c import BaseC, BaseCConfig
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.models.transplant import (
    basec_state_dict_from_jax, bigc_state_dict_from_jax)
from vidsgg_big_tpu_torch.ops.attention import (
    ShardedDraws, attn_chunked_stored, dropout_mask, keep_mask16)
from vidsgg_big_tpu_torch.ops.composed_attn import fused_composed_attention
from vidsgg_big_tpu_torch.parallel.sharding import (
    Shard, mesh_from_spec, param_partition_specs, shard_tensor, tp_plan)
from vidsgg_big_tpu_torch.train.grounding_data import gumbel_noise
from vidsgg_big_tpu_torch.utils.config import parse_config_py

DEMO = os.path.join(os.path.dirname(__file__), "..", "experiments", "demo")
M = 2


def _jax_params(kind):
    """(JAX params tree, port config) of a demo-width model."""
    import jax
    from vidsgg_big_tpu.data.synthetic import make_video as jax_video
    from vidsgg_big_tpu.data.types import (pack_proposal as jax_pack,
                                           stack_batches as jax_stack)
    from vidsgg_big_tpu.models import BigC as JaxBigC
    from vidsgg_big_tpu.models import BigCConfig as JaxBigCConfig
    from vidsgg_big_tpu.models import base_c as jax_base_c
    if kind == "v10":
        mc = parse_config_py(os.path.join(DEMO, "config_smoke_.py"))[
            "model_config"]
        jcfg, cfg = JaxBigCConfig.from_dict(mc), BigCConfig.from_dict(mc)
        model = JaxBigC(jcfg, enti_name_emb=np.zeros(
            (cfg.num_enti_cats, cfg.dim_clsme), np.float32))
        feat = cfg.dim_feat + cfg.dim_i3d
    else:
        mc = parse_config_py(os.path.join(DEMO, "config_vidor_.py"))[
            "model_config"]
        feat = mc["dim_feat"] + mc["dim_clsme"]
        if kind == "v7":
            jcfg = JaxBigCConfig.from_dict(mc, variant="v7")
            cfg = BigCConfig.from_dict(mc, variant="v7")
            model = JaxBigC(jcfg)
        else:
            jcfg = jax_base_c.BaseCConfig.from_dict(mc)
            cfg = BaseCConfig.from_dict(mc)
            model = jax_base_c.BaseC(jcfg)
    props = jax_stack([jax_pack(jax_video(0, video_len=40, feat_dim=feat,
                                          num_enti_cats=cfg.num_enti_cats,
                                          num_pred_cats=cfg.num_pred_cats)[0],
                                16, 64, feat)])
    return model.init(jax.random.PRNGKey(0), props), cfg


def _jax_marks(params):
    """Each leaf of ``params`` marked with its shard under JAX's specs."""
    import flax
    from vidsgg_big_tpu.parallel.sharding import param_partition_specs \
        as jax_specs
    flat = flax.traverse_util.flatten_dict(params)
    specs = flax.traverse_util.flatten_dict(jax_specs(params))
    marks = {}
    for path, x in flat.items():
        shape = np.shape(x)
        out = np.zeros(shape, np.float32)
        for d, axis in enumerate(specs[path]):
            if axis is not None:
                idx = np.arange(shape[d]) // (shape[d] // M) + 1
                out = out + idx.reshape(
                    [-1 if i == d else 1 for i in range(len(shape))])
        marks[path] = np.broadcast_to(out, shape).astype(np.float32)
    return flax.traverse_util.unflatten_dict(marks)


def _port_marks(model):
    """Each parameter of ``model`` marked with its shard under the port's
    plan (:func:`shard_tensor` decides which elements a rank holds)."""
    specs = param_partition_specs(model)
    out = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        mark = torch.zeros(p.shape)
        if spec is not None:
            ids = torch.arange(p.numel(), dtype=torch.float64).reshape(
                p.shape)
            for i in range(M):
                own = shard_tensor(ids, spec, M, i).long().reshape(-1)
                mark.view(-1)[own] = i + 1.0
        out[name] = mark
    return out


@pytest.mark.parametrize("kind", ["v10", "v7", "basec"])
def test_tp_plan_matches_jax_leaf_for_leaf(kind):
    params, cfg = _jax_params(kind)
    if kind == "basec":
        marks = basec_state_dict_from_jax(_jax_marks(params), cfg)
        model = BaseC(cfg)
    else:
        marks = bigc_state_dict_from_jax(_jax_marks(params), cfg)
        model = BigC(cfg)
    port = _port_marks(model)
    assert sum(bool(m.any()) for m in port.values()) >= 8
    for name, mark in port.items():
        assert torch.equal(marks[name], mark), name
    # every split axis divides by 2 at these widths: the plan is the specs
    assert set(tp_plan(model, M)) == {
        n for n, s in param_partition_specs(model).items() if s is not None}


def test_plan_replicates_what_the_extent_does_not_divide():
    """JAX's _fits: 4 heads over 3 model ranks stay whole, as do the 64-wide
    FFNs and MLPs; 4 heads over 4 ranks split."""
    mc = parse_config_py(os.path.join(DEMO, "config_smoke_.py"))[
        "model_config"]
    model = BigC(BigCConfig.from_dict(mc))
    assert tp_plan(model, 3) == {}
    four = tp_plan(model, 4)
    assert four["encoder_layers.0.self_attn.in_proj_weight"] == Shard(0, 3, 4)
    assert four["decoder_layers.1.fc2.3.weight"] == Shard(1)
    assert tp_plan(model, 1) == {}


@pytest.mark.parametrize("spec,shape", [
    ("8", (8, 1)), ("4,2", (4, 2)), (" 2 , 2 ", (2, 2)), ("1,1", (1, 1))])
def test_mesh_spec(spec, shape):
    assert mesh_from_spec(spec) == shape


@pytest.mark.parametrize("spec", ["", "0", "2,2,2", "a", "2,-1"])
def test_mesh_spec_refuses(spec):
    with pytest.raises(ValueError, match="--mesh"):
        mesh_from_spec(spec)


def _share(fn, rows, feats=(0, 1)):
    return fn(ShardedDraws(torch.Generator().manual_seed(7), rows, feats))


@pytest.mark.parametrize("n_rows,n_feats", [(2, 1), (4, 1), (2, 2), (1, 4)])
def test_sharded_draws_are_the_single_draws_cut(n_rows, n_feats):
    """Every draw a sharded step makes is the single process's draw of the
    whole batch, cut to the rank's rows (and features)."""
    full_shape = (8, 4, 6, 6)
    local = (8 // n_rows, 4 // n_feats, 6, 6)
    whole = dropout_mask(full_shape, 0.1, torch.Generator().manual_seed(7),
                         "cpu")
    whole16 = keep_mask16(full_shape, 0.1, torch.Generator().manual_seed(7),
                          "cpu")
    for r in range(n_rows):
        for f in range(n_feats):
            rs = slice(r * local[0], (r + 1) * local[0])
            fs = slice(f * local[1], (f + 1) * local[1])
            got = _share(lambda g: dropout_mask(local, 0.1, g, "cpu", 1),
                         (r, n_rows), (f, n_feats))
            assert torch.equal(got, whole[rs, fs])
            if n_feats == 1:
                got = _share(lambda g: keep_mask16(local, 0.1, g, "cpu"),
                             (r, n_rows))
                assert torch.equal(got, whole16[rs])


def test_sharded_noise_and_row_seeds():
    """The grounding step's Gumbel noise and the composed attention's row
    seeds: each rank's are its rows of the single draw."""
    noise = gumbel_noise((4, 5, 7), torch.Generator().manual_seed(3))
    x = torch.randn(4, 128, 128)
    comp = (torch.randn(8, 128, 128) * 0.01, torch.zeros(8, 128),
            torch.randn(8, 128, 128) * 0.01, torch.zeros(128))
    whole = fused_composed_attention(x, None, *comp, hd=16, dropout=0.1,
                                     generator=torch.Generator().manual_seed(
                                         5))
    for r in range(2):
        g = ShardedDraws(torch.Generator().manual_seed(3), (r, 2))
        assert torch.equal(gumbel_noise((2, 5, 7), g), noise[2 * r:2 * r + 2])
        g = ShardedDraws(torch.Generator().manual_seed(5), (r, 2))
        got = fused_composed_attention(x[2 * r:2 * r + 2], None, *comp,
                                       hd=16, dropout=0.1, generator=g)
        assert torch.equal(got, whole[2 * r:2 * r + 2])


@pytest.mark.parametrize("n_rows,chunk", [(2, 2), (2, 8), (4, 4), (4, 2)])
def test_chunked_stored_attention_draws_the_global_chunks(n_rows, chunk):
    """The chunked stored-softmax path under a data shard draws every global
    chunk's keep-mask in order, so each rank's rows equal the single run's
    (chunks smaller and larger than a rank's rows)."""
    q, k, v = (torch.randn(8, 6, 2, 4) for _ in range(3))
    mask = torch.rand(8, 6) > 0.2
    mask[:, 0] = True
    whole = attn_chunked_stored(q, k, v, mask, chunk=chunk, dropout=0.1,
                                generator=torch.Generator().manual_seed(1))
    n = 8 // n_rows
    for r in range(n_rows):
        rs = slice(r * n, (r + 1) * n)
        got = attn_chunked_stored(
            q[rs], k[rs], v[rs], mask[rs], chunk=chunk, dropout=0.1,
            generator=ShardedDraws(torch.Generator().manual_seed(1),
                                   (r, n_rows)))
        assert torch.equal(got, whole[rs])


def _batches(recs, spec, shard=None, staged=False):
    if not staged:
        return list(bucketed_batches(recs, spec, 4, shard=shard))
    ring = StagingRing("cpu")
    return [(k, rows, *ring.ship((p, g))) for k, rows, p, g in
            bucketed_batches(recs, spec, 4, shard=shard, staging=ring)]


@pytest.mark.parametrize("staged", [False, True], ids=["numpy", "staged"])
def test_bucketed_batches_pack_each_rank_its_rows(staged):
    """With ``shard`` a rank packs its rows of every batch, bucketed and
    masked as the whole batch (a padded remainder batch included), numpy or
    into a staging slot; the records of the whole batch are still
    yielded."""
    recs = [make_video(i, video_len=30 + 10 * i, feat_dim=8)
            for i in range(7)]
    spec = BucketSpec(feat_dim=8)
    whole = _batches(recs, spec)
    for r in range(2):
        part = _batches(recs, spec, (r, 2), staged)
        assert len(part) == len(whole)
        for (k1, rows1, p1, g1), (k2, rows2, p2, g2) in zip(whole, part):
            assert k1 == k2 and [x[0].video_name for x in rows1] == [
                x[0].video_name for x in rows2]
            for a, b in ((p1, p2), (g1, g2)):
                for name, x in vars(a).items():
                    np.testing.assert_array_equal(
                        getattr(b, name), x[2 * r:2 * r + 2], err_msg=name)
    with pytest.raises(ValueError, match="divide"):
        list(bucketed_batches(recs, spec, 3, shard=(0, 2)))
