"""The check of served grounding outputs against the plain reference.

The reference runs the forward and the decode once over the same inputs.

* ``prob_gap``: the largest gap between a served bin probability (the best
  clip's score of the bin) and the reference's.
* ``span_flips``: bins whose served span lies more than ``SPAN_TOL`` from
  the reference's.  A span pools the clips scoring above a share of the
  best and overlapping its span past a threshold: a clip within rounding
  of a threshold may enter on one side and not the other, so a sound run
  reads a few.
* ``mask_flips``: bins kept on one side and not on the other (thresholds,
  NMS).
"""
from __future__ import annotations

import torch

from benchmark.reference import grounding_vidor as ref

SPAN_TOL = 1e-4


def reference_outputs(w, m, inputs, thresholds):
    x = inputs
    regrs, conf, cls = ref.forward(w, m, x["video_feats"], x["clip_mask"],
                                   x["query_cats"], x["temporal"])
    return ref.decode(regrs.float(), conf.float(), cls.float(),
                      x["temporal"].float(), x["n_clips"], x["clip_mask"],
                      x["query_mask"], **thresholds)


def judge(served, expected) -> dict:
    spans, probs, kept = (torch.as_tensor(s).to(e.device)
                          for s, e in zip(served, expected))
    r_spans, r_probs, r_kept = expected
    flips = ((spans - r_spans).abs() > SPAN_TOL).any(-1)
    return {"prob_gap": float((probs - r_probs).abs().max()),
            "span_flips": float(flips.sum()),
            "mask_flips": float((kept != r_kept).sum())}


def control(w, m, inputs, thresholds, expected, dtype) -> dict:
    """The reference in ``dtype`` in the program's place, judged by the
    float32 reference's outputs ``expected``."""
    wl, xl = ref.cast(w, inputs, dtype)
    low = reference_outputs(wl, m, xl, thresholds)
    return judge([t.float() if t.is_floating_point() else t for t in low],
                 expected)
