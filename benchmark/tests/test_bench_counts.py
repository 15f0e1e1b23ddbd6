"""The frozen FLOP counters against ``FlopCounterMode`` over the plain
references' forwards, at small widths on the CPU."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import bigc_v10_exp2 as bigc_counts
from benchmark.counts import grounding_vidor as grounding_counts
from benchmark.counts.kernels import (composed_backward_bound,
                                      composed_forward_bound,
                                      fused_attention_flops,
                                      role_attention_bound,
                                      role_attention_flops)
from benchmark.counts.peaks import PEAK_BYTES_S, PEAK_F32_FLOP_S
from benchmark.harness import draws
from benchmark.harness.grounding import query_batch
from benchmark.harness.tracklets import tracklet_batch
from benchmark.reference import bigc_v10_exp2 as bigc_ref
from benchmark.reference import grounding_vidor as grounding_ref
from benchmark.tests.small import small_cell


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 7])
def test_bigc_forward_flops(seed):
    cell = small_cell("exp2_serve_f32")
    m, tr = cell.config["model_config"], cell.traffic
    from benchmark.drivers.serve_bigc import build_model
    _, w = build_model(m, seed, "cpu")
    batch = tracklet_batch(tr, m, draws.generator(seed, draws.INPUTS, "cpu"),
                           "cpu")

    def forward():
        fwd = bigc_ref.forward(w, m, batch)
        own = fwd["att"].argmax(-1)
        bigc_ref.head(w, m, fwd, own[:, 0], own[:, 1], batch["cat_ids"])

    assert _counted(forward) == bigc_counts.forward_flops(
        m, tr["batch"], tr["slots"], tr["frames"])
    assert bigc_counts.train_step_flops(m, 2, 10, 16) == \
        3 * bigc_counts.forward_flops(m, 2, 10, 16)


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 7])
def test_grounding_forward_flops(seed):
    cell = small_cell("grounding_serve_f32")
    m, tr = cell.config["model_config"], cell.traffic
    from benchmark.drivers.serve_grounding import build_model
    _, w = build_model(m, seed, "cpu")
    x = query_batch(tr, m, draws.generator(seed, draws.INPUTS, "cpu"), "cpu")
    counted = _counted(lambda: grounding_ref.forward(
        w, m, x["video_feats"], x["clip_mask"], x["query_cats"],
        x["temporal"]))
    assert counted == grounding_counts.forward_flops(
        m, tr["batch"], tr["queries"], tr["clips"])


def test_kernel_bounds():
    # role attention at exp2's shapes is bound by its bytes
    b, q, n, dh, de = 8, 192, 50, 256, 512
    nbytes = 4 * (b * 2 * q * dh + b * 2 * n * dh + b * n * de
                  + b * 2 * q * n + b * 2 * q * de) + b * n
    assert role_attention_bound(b, q, n, dh, de) == pytest.approx(
        nbytes / PEAK_BYTES_S)
    assert role_attention_flops(b, q, n, dh, de) / PEAK_F32_FLOP_S < \
        nbytes / PEAK_BYTES_S
    # the composed kernels at R=1,024 x T=512 x d=128 by their operations
    flop = fused_attention_flops(1024, 512, 128, 8)
    assert composed_forward_bound(1024, 8, 512, 128) == pytest.approx(
        flop / PEAK_F32_FLOP_S)
    assert composed_forward_bound(1024, 8, 512, 128) == pytest.approx(
        6.664e-3, rel=1e-3)
    assert composed_backward_bound(1024, 8, 512, 128) == pytest.approx(
        2.5 * flop / PEAK_F32_FLOP_S)
