"""The port's span recorder (``utils/spans.py``) and the spans of its train
and serve steps, on the CPU at the demo configs' widths.

Off, a span is the shared no-op and reaches no profiler; recording, every
step call gives one root and the layer tree below it, each child inside its
parent's interval; a step's outputs and train state are bit-equal with
recording on and off; an exported program holds no span.
"""
import argparse
import threading

import pytest
import torch

from vidsgg_big_tpu_torch.data.bucketing import BucketSpec, bucketed_batches
from vidsgg_big_tpu_torch.data.synthetic import clip_features, make_vidor_video
from vidsgg_big_tpu_torch.data.synthetic_vidvrd import SyntheticVidVRDSet
from vidsgg_big_tpu_torch.data.transfer import batch_to_device
from vidsgg_big_tpu_torch.models.big_c import BigC, BigCConfig
from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                   GroundingModel)
from vidsgg_big_tpu_torch.tools import export_model, train_vidor
from vidsgg_big_tpu_torch.train.grounding_steps import (
    build_grounding_infer_step, build_grounding_train_step)
from vidsgg_big_tpu_torch.train.steps import build_infer_step, build_train_step
from vidsgg_big_tpu_torch.train.train_state import TrainState
from vidsgg_big_tpu_torch.utils import spans
from vidsgg_big_tpu_torch.utils.config import parse_config_py
from vidsgg_big_tpu_torch.utils.serving import (ARTIFACT, flat_leaves,
                                                load_exported)

BIGC_CFG = "experiments/demo/config_smoke_.py"
GRD_CFG = "experiments/demo/config_grounding_.py"
GRD_KW = dict(score_th=0.9, tiou_th=0.5, bins_th=0.2, nms_th=0.8)
OPTIM = ("optim", [("clip", []), ("adam", [])])
# each step's span tree: (name, [children]) in the order the spans open
TREES = {
    "bigc.train": ("bigc.train", [
        ("forward", [("encoder", []), ("decoder", []), ("head", [])]),
        ("loss", [("align", []),
                  ("match", [("match.fetch", []), ("match.solve", []),
                             ("match.upload", [])]),
                  ("terms", [])]),
        ("backward", []), OPTIM]),
    "bigc.infer": ("bigc.infer", [
        ("forward", [("encoder", []), ("decoder", []), ("head", [])]),
        ("postprocess", [])]),
    "grounding.train": ("grounding.train", [
        ("targets", []),
        ("forward", [("embed", []), ("encoders", []), ("fusion", []),
                     ("combined", []), ("heads", [])]),
        ("loss", []), ("backward", []), OPTIM]),
    "grounding.infer": ("grounding.infer", [
        ("forward", [("embed", []), ("encoders", []), ("fusion", []),
                     ("combined", []), ("heads", [])]),
        ("postprocess", [])]),
}


def _bigc(train: bool):
    mc = parse_config_py(BIGC_CFG)["model_config"]
    cfg = BigCConfig.from_dict(mc)
    torch.manual_seed(0)
    model = BigC(cfg)
    data = SyntheticVidVRDSet(2, cfg, model_dims=False)
    spec = BucketSpec(feat_dim=data.feat_dim, g_bucket=8, tg_bucket=256,
                      p_bucket=16)
    _, _, props, gts = next(iter(bucketed_batches(
        (data[i] for i in range(2)), spec, 2)))
    props, gts = batch_to_device(props, gts, torch.device("cpu"),
                                 torch.float32)
    if not train:
        return model, build_infer_step(model, topk=10), lambda s, i: s(props)
    state = TrainState(model, 1e-4, 0.2, [100])
    return state, build_train_step(model, state, t_abs=1024), \
        lambda s, i: s(props, gts, generator=torch.Generator().manual_seed(i))


def _grounding(train: bool):
    cfgs = parse_config_py(GRD_CFG)
    cfg = GroundingConfig.from_dict(cfgs["model_config"])
    torch.manual_seed(0)
    model = GroundingModel(cfg)
    if train:
        rows = []
        for i in range(2):
            _, gt = make_vidor_video(i, feat_dim=4)
            rows.append((clip_features(i, gt.video_len, cfg.dim_feat), gt))
        batch = train_vidor.make_batch(rows, 16, 2, cfg.dim_feat, 8,
                                       torch.float32)
        state = TrainState(model, 5e-5, 0.2, [100])
        return state, build_grounding_train_step(model, state), \
            lambda s, i: s(*batch, generator=torch.Generator().manual_seed(i))
    g = torch.Generator().manual_seed(0)
    b, q, t = 2, 4, 16
    clip_mask = torch.arange(t)[None] < torch.tensor([[12], [16]])
    cats = torch.stack([torch.randint(1, cfg.num_enti_cats, (b, q),
                                      generator=g),
                        torch.randint(1, cfg.num_pred_cats, (b, q),
                                      generator=g),
                        torch.randint(1, cfg.num_enti_cats, (b, q),
                                      generator=g)], -1)
    start = torch.rand(b, q, generator=g) * 0.6
    args = (torch.randn(b, t, cfg.dim_feat, generator=g), clip_mask,
            clip_mask.sum(1), cats, torch.stack([start, start + 0.3], -1),
            torch.ones(b, q, dtype=torch.bool))
    return model, build_grounding_infer_step(model, **GRD_KW), \
        lambda s, i: s(*args)


def _step(root):
    family, kind = root.split(".")
    return (_bigc if family == "bigc" else _grounding)(kind == "train")


def _tree(records, i):
    kids = [j for j, r in enumerate(records) if r.parent == i]
    return (records[i].name, [_tree(records, j) for j in kids])


def test_spans_off_are_the_shared_no_op(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    assert spans.span("forward") is spans.span("loss") is spans._OFF
    _, step, call = _step("bigc.infer")
    call(step, 0)
    assert opened == [] and spans._active is None
    with spans.recording() as records:
        call(step, 0)
    assert opened == [r.name for r in records] and len(records) == 6


@pytest.mark.parametrize("root", list(TREES))
def test_step_span_tree(root):
    _, step, call = _step(root)
    with spans.recording() as records:
        for i in range(2):
            call(step, i)
    roots = [i for i, r in enumerate(records) if r.parent is None]
    assert len(roots) == 2
    for i in roots:
        assert _tree(records, i) == TREES[root]
    for r in records:
        assert r.t0_ns < r.t1_ns
        if r.parent is not None:
            up = records[r.parent]
            assert up.t0_ns < r.t0_ns and r.t1_ns < up.t1_ns


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    if torch.is_tensor(x):
        return [x.detach()]
    return _leaves(vars(x))


def _state(owner):
    if isinstance(owner, TrainState):
        opt = owner.optimizer.state_dict()["state"]
        return [p.detach() for p in owner.params] + \
            [v for k in sorted(opt) for v in _leaves(opt[k])]
    return [p.detach() for p in owner.parameters()]


@pytest.mark.parametrize("root", list(TREES))
def test_outputs_and_state_equal_with_recording(root):
    results = []
    for on in (False, True):
        owner, step, call = _step(root)
        if on:
            with spans.recording() as records:
                outs = [call(step, i) for i in range(2)]
            assert records
        else:
            outs = [call(step, i) for i in range(2)]
        results.append((_leaves(outs), _state(owner)))
    (off_out, off_state), (on_out, on_state) = results
    assert len(off_out) == len(on_out) > 0
    for a, b in zip(off_out + off_state, on_out + on_state):
        assert torch.equal(a, b)


def test_export_inside_recording_equals_outside(tmp_path):
    args = argparse.Namespace(
        cfg_path=BIGC_CFG, model="bigc_vidvrd", ckpt_path=None,
        tables_path=None, n_bucket=8, t_bucket=32, q_bucket=4,
        batch_size=2, topk=None, feat_dtype="float32", compute_dtype=None,
        device="cpu")
    export_model.export_model(argparse.Namespace(**vars(args),
                                                 out=str(tmp_path / "off")))
    with spans.recording() as records:
        export_model.export_model(argparse.Namespace(
            **vars(args), out=str(tmp_path / "on")))
    assert records == []
    graphs = [torch.export.load(str(tmp_path / d / ARTIFACT)).graph_module.code
              for d in ("off", "on")]
    assert graphs[0] == graphs[1]
    mc = parse_config_py(BIGC_CFG)["model_config"]
    batch = export_model.tracklet_template(
        args, mc["dim_feat"] + mc["dim_i3d"], mc["num_enti_cats"],
        mc["num_pred_cats"], 64, "cpu")
    off, on = (load_exported(str(tmp_path / d))[0](batch)
               for d in ("off", "on"))
    for a, b in zip(flat_leaves(off), flat_leaves(on)):
        assert torch.equal(a, b)


def test_exception_closes_its_span():
    with spans.recording() as records:
        with spans.span("step"):
            with pytest.raises(ValueError):
                with spans.span("inner"):
                    raise ValueError("inside a span")
            with spans.span("after"):
                pass
    assert [(r.name, r.parent) for r in records] == [
        ("step", None), ("inner", 0), ("after", 0)]
    assert all(r.t1_ns is not None for r in records)
    assert spans._active is None


def test_only_the_recording_thread_records():
    seen = []

    def other():
        seen.append(spans.span("elsewhere"))
    with spans.recording() as records:
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=10)
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert not thread.is_alive()
    assert seen == [spans._OFF] and records == []


def test_profile_puts_kernels_down_to_the_innermost_span():
    from types import SimpleNamespace as NS

    from vidsgg_big_tpu_torch.tools import profile_infer

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, start, end, kernels=(), device=cpu):
        return NS(name=name, device_type=device, kernels=[
            NS(name=k, duration=d) for k, d in kernels],
            time_range=NS(start=start, end=end))
    events = [ev("step", 0, 100), ev("forward", 10, 40),
              ev("aten::mm", 12, 14, [("gemm", 30.0)]),
              ev("aten::add", 50, 51, [("add", 2.0), ("add", 3.0)]),
              ev("aten::clamp", 120, 121, [("clamp", 4.0)]),
              ev("gemm", 15, 45, device=cuda)]
    table = profile_infer.span_kernels(events, {"step", "forward"})
    iters = profile_infer.ITERS
    assert list(table) == ["forward", "step", "(none)"]
    assert table["forward"]["device_ms_per_batch"] == 0.03 / iters
    assert table["step"]["launches_per_batch"] == 2 / iters
    assert table["step"]["top_kernels"] == [["add", 0.005 / iters]]
    assert table["(none)"]["top_kernels"] == [["clamp", 0.004 / iters]]
