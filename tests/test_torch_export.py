"""Export and serving of the port (``tools/export_model.py``,
``utils/serving.py``) and the kernels' registered ops, on the CPU.

Each family is exported at ``tests/test_export.py``'s small configs from
JAX's first weights carried across (``*_state_dict_from_jax``), saved,
reloaded through ``load_exported`` and held against the port's live infer
step (integer and bool leaves exactly, float leaves within 1e-6) and against
JAX's live infer step (the port's eval-test tolerances: masks, ids and
durations exactly, scores within 1e-5).
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import flax.linen
import jax
import pytest
import torch

from vidsgg_big_tpu.train.grounding_steps import (
    build_grounding_infer_step as jax_grounding_infer_step)
from vidsgg_big_tpu.train.steps import (
    build_basec_infer_step as jax_basec_infer_step,
    build_infer_step as jax_infer_step)
from vidsgg_big_tpu.utils.config import parse_config_py as jax_parse_config
from vidsgg_big_tpu_torch.models.base_c import BaseCConfig
from vidsgg_big_tpu_torch.models.big_c import BigCConfig
from vidsgg_big_tpu_torch.models.transplant import (
    basec_state_dict_from_jax, bigc_state_dict_from_jax,
    grounding_state_dict_from_jax)
from vidsgg_big_tpu_torch.ops import build
from vidsgg_big_tpu_torch.ops.composed_attn import (
    composed_attention, composed_attention_op, composed_attention_plain)
from vidsgg_big_tpu_torch.ops.role_attn import (role_attention,
                                                role_attention_op,
                                                role_attention_plain)
from vidsgg_big_tpu_torch.tools import export_model
from vidsgg_big_tpu_torch.train.grounding_steps import (
    build_grounding_infer_step)
from vidsgg_big_tpu_torch.train.steps import (build_basec_infer_step,
                                              build_infer_step)
from vidsgg_big_tpu_torch.utils import compile_cache
from vidsgg_big_tpu_torch.utils.config import parse_config_py
from vidsgg_big_tpu_torch.utils.serving import (ARTIFACT, flat_leaves,
                                                load_exported)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRD_KW = dict(score_th=0.9, tiou_th=0.5, bins_th=0.2, nms_th=0.8)


def _jax_test_configs():
    """BIGC_CFG, BASEC_CFG and GRD_CFG of the JAX package's
    tests/test_export.py, read from its source."""
    with open(os.path.join(REPO, "tests", "test_export.py")) as f:
        src = f.read()
    return {name: re.search(name + r' = """(.*?)"""', src, re.S).group(1)
            for name in ("BIGC_CFG", "BASEC_CFG", "GRD_CFG")}


CONFIGS = _jax_test_configs()
# BIG-C v7 reads RoI + classeme channels and no I3D: the BIG-C config less
# its dim_i3d
CONFIGS["VIDOR_CFG"] = CONFIGS["BIGC_CFG"].replace("dim_i3d=8, ", "")
FAMILY_CFG = {"bigc_vidvrd": "BIGC_CFG", "bigc_vidor": "VIDOR_CFG",
              "base_c": "BASEC_CFG", "grounding": "GRD_CFG"}


def jax_export_tool():
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_export_model", os.path.join(tools, "export_model.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


def _args(cfg_path, model, out, **kw):
    flags = dict(cfg_path=str(cfg_path), model=model, ckpt_path=None,
                 tables_path=None, out=str(out), n_bucket=8, t_bucket=32,
                 q_bucket=4, batch_size=2, topk=None, feat_dtype="float32",
                 compute_dtype=None, device="cpu")
    return argparse.Namespace(**dict(flags, **kw))


@contextlib.contextmanager
def _jitted_init():
    """flax's ``Module.init`` under ``jax.jit`` while JAX's export tool
    builds a model: the same initialisers from the same key, compiled once
    instead of run op by op (about 10 s of this file's time on the CPU).
    Both packages then start from the weights so made."""
    init = flax.linen.Module.init

    def jitted(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: init(self, r, *a, **kwargs))(rngs,
                                                                   *args)

    flax.linen.Module.init = jitted
    try:
        yield
    finally:
        flax.linen.Module.init = init


def _jax_family(tmp_path, family):
    """JAX's model, params and template (built by its export tool, seed 0)
    and its live infer step for ``family``."""
    cfg_path = tmp_path / f"{family}_config_.py"
    cfg_path.write_text(CONFIGS[FAMILY_CFG[family]])
    tool = jax_export_tool()
    args = _args(cfg_path, family, tmp_path / "unused", platforms="cpu")
    mc = jax_parse_config(str(cfg_path))["model_config"]
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)    # they import tools/common lazily
    try:
        with _jitted_init():
            return _jax_built(tool, args, mc, family, cfg_path)
    finally:
        sys.path.remove(tools)


def _jax_built(tool, args, mc, family, cfg_path):
    """The family built as JAX's export tool builds it, and JAX's live
    infer step on its template."""
    if family == "base_c":
        model, params, template, _ = tool.build_basec_and_params(args, mc)
        infer = jax_basec_infer_step(model, topk=5)
        return cfg_path, model, params, infer(params, template)
    if family == "grounding":
        model, params, template, _ = tool.build_grounding_and_params(
            args, mc)
        infer = jax_grounding_infer_step(model, **GRD_KW)
        return cfg_path, model, params, infer(params, *template)
    model, params, template, _ = tool.build_model_and_params(args, mc)
    return cfg_path, model, params, jax_infer_step(model, topk=5)(
        params, template)


def _port_state(family, params, cfg_path):
    mc = parse_config_py(str(cfg_path))["model_config"]
    if family == "base_c":
        return basec_state_dict_from_jax(params, BaseCConfig.from_dict(mc))
    if family == "grounding":
        return grounding_state_dict_from_jax(params)
    # no tables file: zero name tables, v7's sine position table
    variant = {"bigc_vidvrd": "v10", "bigc_vidor": "v7"}[family]
    return bigc_state_dict_from_jax(
        params, BigCConfig.from_dict(mc, variant=variant))


def _port_live(family, args):
    """The port's model, template and live output, built as the export
    tool builds them."""
    mc = parse_config_py(args.cfg_path)["model_config"]
    if args.compute_dtype:
        mc = dict(mc, compute_dtype=args.compute_dtype)
    cpu = torch.device("cpu")
    if family == "base_c":
        model, template, _ = export_model.build_basec_and_params(args, mc,
                                                                 cpu)
        return template, build_basec_infer_step(model, topk=5)(template)
    if family == "grounding":
        model, template, _ = export_model.build_grounding_and_params(
            args, mc, cpu)
        return template, build_grounding_infer_step(model, **GRD_KW)(
            *template)
    model, template, _ = export_model.build_model_and_params(args, mc, cpu)
    return template, build_infer_step(model, topk=5)(template)


def _same_leaves(served, live):
    """Integer and bool leaves exactly, float leaves within 1e-6."""
    a, b = flat_leaves(served), flat_leaves(live)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
        else:
            assert torch.equal(x, y)


def _op_nodes(out_dir):
    program = torch.export.load(os.path.join(out_dir, ARTIFACT))
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "vidsgg_big_tpu_torch" in
            str(n.target)]


# ---- the registered ops ---------------------------------------------------

def test_role_attention_op_passes_opcheck():
    """Schema, fake (shapes, dtypes and strides against the CPU kernel) and
    dispatch of the role-attention op, on the decoder's strided views and a
    padded bool mask; the public wrapper returns the plain version's
    values."""
    rng = np.random.default_rng(0)
    b, q, n, dh, de = 2, 5, 7, 8, 12
    proj_p = torch.from_numpy(rng.normal(size=(b, q, 2 * dh)).astype(
        np.float32))
    proj_e = torch.from_numpy(rng.normal(size=(b, n, 2 * dh)).astype(
        np.float32))
    p = proj_p.unflatten(-1, (2, dh)).transpose(1, 2)
    e = proj_e.unflatten(-1, (2, dh)).transpose(1, 2)
    enco = torch.from_numpy(rng.normal(size=(b, n, de)).astype(np.float32))
    mask = torch.arange(n)[None] < torch.tensor([[n], [4]])
    assert not p.is_contiguous()
    torch.library.opcheck(role_attention_op, (p, e, enco, mask, dh))
    torch.library.opcheck(role_attention_op, (p.contiguous(), e, enco,
                                              mask.to(torch.uint8), dh))
    before = role_attention.launches
    got = role_attention(p, e, enco, mask, dh)
    want = role_attention_plain(p, e, enco, mask, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert role_attention.launches == before


def test_composed_attention_op_passes_opcheck():
    """The same for the composed inference forward, float32 and bfloat16,
    on contiguous operands and on a strided view of the keys."""
    rng = np.random.default_rng(1)
    r, h, t, d = 2, 8, 16, 16
    qh, vt = (torch.from_numpy(rng.normal(size=(r, h, t, d)).astype(
        np.float32)) for _ in range(2))
    wide = torch.from_numpy(rng.normal(size=(r, t, 2 * d)).astype(np.float32))
    x = wide[..., :d]
    bias = torch.where(torch.arange(t)[None] < torch.tensor([[t], [9]]),
                       0.0, -1e30)
    assert not x.is_contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        ops = [a.to(dtype) for a in (qh, x.contiguous(), vt)]
        torch.library.opcheck(composed_attention_op, (*ops, bias, 0.25))
    torch.library.opcheck(composed_attention_op, (qh, x, vt, bias, 0.25))
    before = composed_attention.launches
    torch.testing.assert_close(composed_attention(qh, x, vt, bias, 0.25),
                               composed_attention_plain(qh, x, vt, bias,
                                                        0.25),
                               rtol=0, atol=0)
    assert composed_attention.launches == before


# ---- the four families ----------------------------------------------------

@pytest.mark.parametrize("family", ["bigc_vidvrd", "bigc_vidor", "base_c",
                                    "grounding"])
def test_export_from_jax_weights_serves_as_live(tmp_path, family):
    """Export from JAX's first weights carried across, save, reload through
    load_exported: the served output equals the port's live infer step
    (integer and bool leaves exactly, floats within 1e-6) and JAX's live
    infer step (masks, quintuples, durations and query ids exactly, scores
    and spans within 1e-5).  The BIG-C graphs hold the role-attention op,
    one a decoder layer."""
    cfg_path, _, params, jax_out = _jax_family(tmp_path, family)
    ckpt = tmp_path / "jax_weights.pt"
    torch.save(_port_state(family, params, cfg_path), ckpt)
    args = _args(cfg_path, family, tmp_path / "artifact",
                 ckpt_path=str(ckpt))
    manifest = export_model.export_model(args)
    serve, man = load_exported(str(tmp_path / "artifact"))
    assert man["model"] == family and man["topk"] == 5
    template, live = _port_live(family, args)
    served = serve(template)
    _same_leaves(served, live)
    jax_out = jax.device_get(jax_out)
    if family == "grounding":
        assert isinstance(served, tuple) and man["output_type"] is None
        np.testing.assert_array_equal(served[2].numpy(),
                                      np.asarray(jax_out[2]))
        for g, w in zip(served[:2], jax_out[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        assert _op_nodes(tmp_path / "artifact") == []
        return
    assert type(served).__name__ == "Triplets"
    trip = served.numpy()
    v = trip.valid
    np.testing.assert_array_equal(v, np.asarray(jax_out.valid))
    assert v.any()
    for name in ("quintuples", "dura_inters"):
        np.testing.assert_array_equal(getattr(trip, name)[v],
                                      np.asarray(getattr(jax_out, name))[v])
    np.testing.assert_array_equal(trip.query_ids,
                                  np.asarray(jax_out.query_ids))
    np.testing.assert_allclose(trip.scores, np.asarray(jax_out.scores),
                               atol=1e-5)
    want_ops = ([] if family == "base_c" else
                ["vidsgg_big_tpu_torch.role_attention.default"] * 2)
    assert _op_nodes(tmp_path / "artifact") == want_ops
    assert manifest["inputs"]["feats"][0] == list(template.feats.shape)


@pytest.mark.parametrize("feat_dtype,compute_dtype", [
    ("bfloat16", "bfloat16"), ("int8", "float32")])
def test_bf16_and_int8_exports_serve_as_live(tmp_path, feat_dtype,
                                             compute_dtype):
    """bfloat16 storage and compute, and int8 storage (the int8 first
    layer): the reloaded artifact equals the live step, floats within
    1e-6, the rest exactly."""
    cfg_path = tmp_path / "config_.py"
    cfg_path.write_text(CONFIGS["BIGC_CFG"])
    args = _args(cfg_path, "bigc_vidvrd", tmp_path / "artifact",
                 feat_dtype=feat_dtype, compute_dtype=compute_dtype)
    manifest = export_model.export_model(args)
    assert manifest["inputs"]["feats"][1] == feat_dtype
    assert manifest["compute_dtype"] == compute_dtype
    serve, _ = load_exported(str(tmp_path / "artifact"))
    template, live = _port_live("bigc_vidvrd", args)
    _same_leaves(serve(template), live)


@pytest.fixture(scope="module")
def grounding_d128(tmp_path_factory):
    """A grounding config whose attention takes the composed path (d=128,
    T=128, a small logits budget) and whose 27 convs take the dwsep_conv op
    (float32 at C = 128), exported once: ``(args, out_dir, op names)``."""
    tmp = tmp_path_factory.mktemp("grounding_d128")
    cfg_path = tmp / "config_.py"
    cfg_path.write_text(CONFIGS["GRD_CFG"].replace(
        "dim_hidden=32,", "dim_hidden=128, attn_bytes_budget=1 << 16,"))
    args = _args(cfg_path, "grounding", tmp / "artifact", t_bucket=128,
                 q_bucket=2, batch_size=1)
    export_model.export_model(args)
    return args, tmp / "artifact", _op_nodes(tmp / "artifact")


def test_grounding_export_holds_the_composed_op(grounding_d128):
    """The graph holds the composed op in each encoder that takes the
    composed path, no other op of the port's but the convs', and the
    artifact equals the live step."""
    args, out_dir, ops = grounding_d128
    assert "vidsgg_big_tpu_torch.composed_attention.default" in ops
    assert set(ops) - {"vidsgg_big_tpu_torch.dwsep_conv.default"} == {
        "vidsgg_big_tpu_torch.composed_attention.default"}
    serve, _ = load_exported(str(out_dir))
    template, live = _port_live("grounding", args)
    _same_leaves(serve(template), live)


def test_grounding_export_holds_the_dwsep_conv_op(grounding_d128):
    """At that width each of the model's 27 convs is one dwsep_conv node."""
    _, _, ops = grounding_d128
    assert ops.count("vidsgg_big_tpu_torch.dwsep_conv.default") == 27


def test_grounding_artifact_serves_in_a_fresh_process(grounding_d128,
                                                      tmp_path):
    """A process that imports only ``utils.serving`` loads the dim-128
    grounding artifact (load_exported registers every op it holds) and
    serves the live step's output."""
    args, out_dir, _ = grounding_d128
    template, live = _port_live("grounding", args)
    torch.save(template, tmp_path / "template.pt")
    script = (
        "import sys, torch\n"
        "from vidsgg_big_tpu_torch.utils.serving import load_exported\n"
        "serve, _ = load_exported(sys.argv[1])\n"
        "torch.save(tuple(serve(torch.load(sys.argv[2]))), sys.argv[3])\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(out_dir),
         str(tmp_path / "template.pt"), str(tmp_path / "served.pt")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _same_leaves(torch.load(tmp_path / "served.pt"), live)


def test_manifest_keys_equal_jax(tmp_path):
    """The manifest has JAX's keys, less ``platforms`` and plus ``device``,
    and the same inputs (names, shapes, dtypes), output fields and bucket
    values for the same flags."""
    cfg_path = tmp_path / "config_.py"
    cfg_path.write_text(CONFIGS["BIGC_CFG"])
    tool = jax_export_tool()
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        tool.export_model(_args(cfg_path, "bigc_vidvrd", tmp_path / "jax",
                                platforms="cpu"))
    finally:
        sys.path.remove(tools)
    export_model.export_model(_args(cfg_path, "bigc_vidvrd",
                                    tmp_path / "port"))
    with open(tmp_path / "jax" / "manifest.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        got = json.load(f)
    assert set(got) == set(want) - {"platforms"} | {"device"}
    for key in ("model", "topk", "batch_size", "n_bucket", "t_bucket",
                "q_bucket", "feat_dim", "feat_dtype", "compute_dtype",
                "inputs", "output_fields", "ckpt_path", "cfg_path"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu"
    assert got["output_type"] == \
        "vidsgg_big_tpu_torch.models.triplets.Triplets"


def test_serving_returns_raw_leaves_without_the_output_type(tmp_path):
    """Where the manifest's output type cannot be imported the call
    returns the raw tuple of leaves, as JAX's loader does."""
    cfg_path = tmp_path / "config_.py"
    cfg_path.write_text(CONFIGS["BASEC_CFG"])
    args = _args(cfg_path, "base_c", tmp_path / "artifact")
    export_model.export_model(args)
    man_path = tmp_path / "artifact" / "manifest.json"
    man = json.loads(man_path.read_text())
    man_path.write_text(json.dumps(dict(man, output_type="no_such.Module")))
    serve, _ = load_exported(str(tmp_path / "artifact"))
    template, live = _port_live("base_c", args)
    out = serve(template)
    assert isinstance(out, tuple)
    assert [f.name for f in dataclasses.fields(live)] == man["output_fields"]
    _same_leaves(out, live)


# ---- the kernel directory -------------------------------------------------

def test_enable_compilation_cache_moves_the_build_directory(tmp_path,
                                                           monkeypatch):
    """The default stays; a directory given or named by the variable
    becomes the kernels' build directory, read at call time."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    default = build.BUILD_DIR
    assert default == build.PACKAGE_DIR.parent / "build" / \
        "vidsgg_big_tpu_torch"
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable_compilation_cache() is False
    assert build.BUILD_DIR == default
    assert compile_cache.enable_compilation_cache(str(tmp_path / "a"))
    assert build.BUILD_DIR == (tmp_path / "a").resolve()
    assert build.library_path("role_attn").parent == (tmp_path / "a").resolve()
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "b"))
    assert compile_cache.enable_compilation_cache()
    assert build.BUILD_DIR == (tmp_path / "b").resolve()
    assert (tmp_path / "b").is_dir()
    assert build.library_path("packer").parent == (tmp_path / "b").resolve()
