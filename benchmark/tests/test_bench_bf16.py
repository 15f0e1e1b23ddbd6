"""The bfloat16 cell's pieces on the CPU: the suite reaches it through
``BENCHMARK.json`` with its float8 control and faults, its driver builds a
model that computes in bfloat16 and refuses one that does not, the float8
rounding of the control and its mode over products, the reference at the
cell's stated precision, the FLOP split by dtype and the ``mfu`` that
prices it, and the conv kernel's bound and roofline."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.checks import fp8
from benchmark.counts import bigc_v10_exp2 as bigc_counts
from benchmark.counts.bigc_v10_exp2_bf16 import (bf16_flops,
                                                 forward_flops_by_dtype)
from benchmark.counts.kernels import dwsep_conv_bound
from benchmark.counts.peaks import (PEAK_BF16_FLOP_S, PEAK_BYTES_S,
                                    PEAK_F32_FLOP_S)
from benchmark.harness.runtime import BENCH_DIR, load_module
from benchmark.harness.session import serve_window
from benchmark.reference import bigc_v10_exp2 as bigc_ref
from benchmark.tests import faults, test_bench_cells
from benchmark.tests.small import small_cell
from vidsgg_big_tpu_torch.models.big_c import BigCConfig

CELL = "exp2_serve_bf16_b32"
SEED = 2 ** 33 + 19


def _metric(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def test_suite_reaches_the_bf16_cell():
    assert CELL in test_bench_cells.CELLS
    cell = small_cell(CELL)
    assert cell.traffic["compute_dtype"] == "bfloat16"
    assert cell.driver.Work.control_dtype == torch.float8_e4m3fn
    found = [f.__name__ for f in faults.load(cell.traffic["driver"])]
    assert found == ["alter_token"]
    assert [(c, f.__name__) for c, f in test_bench_cells.FAULTS
            if c == CELL] == [(CELL, f) for f in found]


def test_driver_computes_in_bfloat16():
    cell = small_cell(CELL)
    work = cell.driver.build(cell, SEED, "cpu")
    assert work.dtype == "bfloat16"
    assert all(x["feats"].dtype == torch.bfloat16 for x in work.inputs)
    assert set(work.flops_by_dtype) == {"bfloat16", "float32"}
    assert sum(work.flops_by_dtype.values()) == work.flops_per_step
    work.release()


def test_driver_refuses_a_model_that_ignores_the_dtype(monkeypatch):
    cell = small_cell(CELL)
    real = BigCConfig.from_dict.__func__

    def float32(cls, d):
        return real(cls, dict(d, compute_dtype="float32"))
    monkeypatch.setattr(BigCConfig, "from_dict", classmethod(float32))
    with pytest.raises(RuntimeError, match="bfloat16"):
        cell.driver.build(cell, SEED, "cpu")


def test_both_controls_read_over_a_limit():
    """The float8 control and the whole reference in bfloat16, each judged
    by the reference at the stated precision, fail the committed limits."""
    cell = small_cell(CELL)
    work = cell.driver.build(cell, SEED, "cpu")
    _, _, _, sample = serve_window(work, 0.2, 3, SEED, "cpu")
    work.release()
    limits = cell.traffic["limits"]
    readings = work.controls(sample)
    assert set(readings) == {"control", "reference_bf16"}
    for got in readings.values():
        assert any(got[n] > limits[n] for n in got), readings


def test_through_float8():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 48, generator=g) * 0.03
    y = fp8.through(x)
    scale = 2.0 ** torch.ceil(torch.log2(x.abs().max() / 448.0))
    q = y / scale
    assert y.dtype == x.dtype
    assert torch.equal(q.to(torch.float8_e4m3fn).float(), q)
    assert torch.equal(y.to(torch.bfloat16).float(), y)
    err = (y - x).abs()
    assert float(err.max()) > 0
    # three mantissa bits: at most half a step of 2^-3 of the value, or of
    # the smallest normal where the value is subnormal
    assert bool((err <= 2.0 ** -4 * torch.maximum(
        x.abs(), 2.0 ** -6 * scale) + 1e-12).all())


def test_through_bfloat16_is_a_cast():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(64, 48, generator=g) * 1e-30
    assert torch.equal(fp8.through(x, torch.bfloat16),
                       x.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.bfloat16])
def test_products_round_the_operands_of_products(dtype):
    g = torch.Generator().manual_seed(6)
    x, w, v = (torch.randn(8, 16, generator=g) for _ in range(3))
    bias = torch.randn(8, generator=g)
    k = torch.randn(4, 8, 3, generator=g)
    kb = torch.randn(4, generator=g)

    def low(t):
        return fp8.through(t, dtype)

    def out(t):
        return t.to(torch.bfloat16).float()
    with fp8.Products([w, k], dtype):
        assert torch.equal(F.linear(x, w, bias),
                           out(F.linear(low(x), low(w), out(bias))))
        assert torch.equal(F.conv1d(x[None], k), out(F.conv1d(low(x[None]),
                                                              low(k))))
        # the conv's bias is added to its rounded result, as the port does
        assert torch.equal(
            F.conv1d(x[None], k, kb, padding=1),
            out(out(F.conv1d(low(x[None]), low(k), padding=1))
                + out(kb)[:, None]))
        # a product of another weight keeps its operands
        assert torch.equal(F.linear(x, v), x @ v.t())
        # a mode inside it that rounds the same product decides alone
        with fp8.Products([w]):
            assert torch.equal(F.linear(x, w, bias), out(F.linear(
                fp8.through(x), fp8.through(w), out(bias))))
    assert not torch.equal(F.linear(low(x), low(w)), F.linear(x, w))


def test_stated_is_bigc_bf16_products():
    cell = small_cell(CELL)
    from benchmark.drivers.serve_bigc import build_model
    _, w = build_model(cell.config["model_config"], SEED, "cpu")
    mode = fp8.stated(w)
    names = {k for k, v in w.items() if id(v) in mode.only}
    assert names == {f"{p}.weight" for p in (
        "fc_bbox2enti.0", "fc_bbox2enti.2", "fc_feat2enti.0",
        "fc_feat2enti.2", "conv_feat2enti", "fc_i3d.0")}
    assert mode.dtype == torch.bfloat16


def test_bigc_flops_by_dtype():
    cell = small_cell(CELL)
    m, tr = cell.config["model_config"], cell.traffic
    b, n, t = tr["batch"], tr["slots"], tr["frames"]
    split = forward_flops_by_dtype(m, b, n, t)
    assert sum(split.values()) == bigc_counts.forward_flops(m, b, n, t)
    assert split["bfloat16"] > 0 and split["float32"] > 0
    # the bfloat16 part: the reference's frame MLPs, temporal conv and
    # fc_i3d at the same shapes, counted by FlopCounterMode
    e, q = m["dim_enti"], m["num_querys"]
    from benchmark.drivers.serve_bigc import build_model
    _, w = build_model(m, SEED, "cpu")

    def pieces():
        bigc_ref._mlp(w, torch.zeros(b, n, t, 8), "fc_bbox2enti", 2)
        bigc_ref._mlp(w, torch.zeros(b, n, t, m["dim_feat"]),
                      "fc_feat2enti", 2)
        torch.nn.functional.conv1d(
            torch.zeros(b * n, 2 * e, t), w["conv_feat2enti.weight"],
            w["conv_feat2enti.bias"], stride=2, padding=1)
        for _ in range(2):
            bigc_ref._mlp(w, torch.zeros(b, q, m["dim_i3d"]), "fc_i3d", 1)
    with FlopCounterMode(display=False) as counter:
        pieces()
    assert counter.get_total_flops() == bf16_flops(m, b, n, t)


def test_mfu_prices_each_dtype_at_its_peak():
    read = _metric("mfu.serve_bf16")
    work = SimpleNamespace(flops_by_dtype={"bfloat16": 989e12 * 0.002,
                                           "float32": 165e12 * 0.003})
    run = SimpleNamespace(kind="serve", steps=10, window_s=0.1, work=work)
    # 2 ms + 3 ms at the peaks over 10 ms a step
    assert read(run) == pytest.approx(50.0)
    assert PEAK_BF16_FLOP_S == 989e12 and PEAK_F32_FLOP_S == 165e12
    run.kind = "train"
    assert read(run) is None
    run.kind = "serve"
    assert read(SimpleNamespace(kind="serve", steps=10, window_s=0.1,
                                work=SimpleNamespace())) is None


def test_dwsep_conv_bound():
    # the four shapes of a grounding request at R=1,024 x T=512 x C=128
    # (PERF.md, the conv kernel's row): bound by their bytes
    r, t, c = 1024, 512, 128
    k7 = dwsep_conv_bound(r, t, c, c, 7, residual=True, mask=True)
    assert k7 == pytest.approx(4 * (3 * r * t * c + 7 * c + c + c * c + c)
                               / PEAK_BYTES_S + r * t / PEAK_BYTES_S)
    assert k7 == pytest.approx(0.2406e-3, rel=1e-3)
    assert dwsep_conv_bound(r, t, c, c, 3, mask=True) == pytest.approx(
        0.1604e-3, rel=1e-3)
    assert dwsep_conv_bound(r, t, c, 20, 3) == pytest.approx(0.0927e-3,
                                                             rel=1e-3)
    assert dwsep_conv_bound(r, t, c, 10, 3) == pytest.approx(0.0864e-3,
                                                             rel=1e-3)


def test_dwsep_conv_roofline():
    module = load_module(BENCH_DIR / "metrics" / "dwsep_conv_roofline.py",
                         "bench_metric_dwsep_conv_roofline")
    cell = small_cell("grounding_serve_f32")
    m = cell.config["model_config"]
    full = dict(cell.traffic, batch=4, queries=256, clips=512)
    bounds = module.request_bounds(dict(m, dim_hidden=128, num_bins=10),
                                   full)
    assert len(bounds) == 27
    assert sorted(bounds)[-1] == pytest.approx(0.2406e-3, rel=1e-3)
    per_call = sum(bounds) / 27

    class Trace:
        def __init__(self, launches):
            self.launches = launches

        def kernels(self, pattern):
            assert pattern == module.PATTERN
            return self.launches

    work = SimpleNamespace(m=dict(m, dim_hidden=128, num_bins=10),
                           traffic=full)
    run = SimpleNamespace(kind="serve", work=work, traced_steps=2,
                          trace=Trace([("dwsep_conv_kernel", 2 * per_call)]
                                      * 54))
    assert module.read(run) == pytest.approx(50.0)
    run.trace = Trace([])
    assert module.read(run) is None
    run.kind = "train"
    assert module.read(run) is None
