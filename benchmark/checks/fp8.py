"""The check of a bfloat16 cell and its controls.

The yardstick is the float32 reference at the precision that the cell
states (:func:`stated`): the operands, bias and result of each product that
the program runs in bfloat16 rounded through bfloat16, every other
operation in float32.  Against it a sound program differs by the order of
its float32 sums and the bfloat16 roundings that this flips or that the
program makes twice (PyTorch runs a linear on a strided operand as a
product, then a bias add), far less than by the float32 parts in bfloat16,
so a limit set over it holds both kinds of the configuration's precision:

* the control, one precision below the bfloat16 products: the reference
  with their operands rounded through float8 e4m3 (:func:`bigc_serve`);
* the whole reference in bfloat16 (``triplets.control``): a program that
  computes the float32 parts (decoder, head, role attention) in bfloat16.

A float8 operand is rounded with a power-of-two scale a tensor that brings
its largest magnitude within the format's (as float8 products are fed), so
the rounded values are exact in bfloat16; a product's bias and result are
bfloat16, as a float8 product's epilogue gives them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from benchmark.checks import triplets
from benchmark.reference import bigc_v10_exp2 as bigc

FP8 = torch.float8_e4m3fn


def through(x, dtype=FP8):
    """``x`` rounded through ``dtype``, in x's dtype: with a power-of-two
    scale where ``dtype`` has fewer exponents than float32, plainly cast
    where it has as many (bfloat16, as the program casts)."""
    if torch.finfo(dtype).max > 1e38:
        return x.to(dtype).to(x.dtype)
    amax = x.abs().amax().float()
    if not float(amax):
        return x
    scale = torch.exp2(torch.ceil(torch.log2(amax / torch.finfo(dtype).max)))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class Products(TorchFunctionMode):
    """Under it, the ``F.linear`` and ``F.conv1d`` calls whose weight is one
    of ``weights`` take their operands rounded through ``dtype`` and give
    their bias and result in bfloat16, as a bfloat16 or float8 product does
    (a convolution's bias added to its rounded result, as the port's encoder
    adds it).  A product whose weight is another tensor, such as one already
    rounded by a mode inside this one, passes unchanged."""

    ROUNDED = (F.linear, F.conv1d)

    def __init__(self, weights, dtype=FP8):
        super().__init__()
        self.only = {id(w) for w in weights}
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func not in self.ROUNDED or id(args[1]) not in self.only:
            return func(*args, **kwargs)
        args = list(args)
        bias = args.pop(2) if len(args) > 2 else kwargs.pop("bias", None)
        x, w = (through(a, self.dtype) for a in args[:2])

        def out(t):
            return through(t, torch.bfloat16)
        bias = None if bias is None else out(bias)
        if func is F.conv1d and bias is not None:
            y = out(func(x, w, None, *args[2:], **kwargs))
            return out(y + bias[:, None])
        return out(func(x, w, bias, *args[2:], **kwargs))


# BIG-C layers that the port's bfloat16 compute runs in bfloat16
# (``TrackletEncoder.encode``: the two per-frame MLPs and the temporal conv;
# the head's ``fc_i3d`` on bfloat16-stored features)
BIGC_BF16_LAYERS = ("fc_bbox2enti.", "fc_feat2enti.", "conv_feat2enti.",
                    "fc_i3d.")


def bf16_weights(w) -> list:
    """The weights of BIG-C's bfloat16 products in the state dict ``w``."""
    return [v for k, v in w.items()
            if k.startswith(BIGC_BF16_LAYERS) and v.dim() >= 2]


def stated(w) -> Products:
    """BIG-C's reference at the precision that a bfloat16 cell states:
    ``BIGC_BF16_LAYERS``' products in bfloat16, the rest in float32."""
    return Products(bf16_weights(w), torch.bfloat16)


def bigc_serve(w, m, batch, fwd, trip, topk: int, dtype=FP8) -> dict:
    """The reference with the operands of BIG-C's bfloat16 products rounded
    through ``dtype`` (their results in bfloat16) in the program's place: at
    each query its own subject and object, at the served subject and object
    its own top-k classes and scores, judged by ``fwd``, the reference at
    the stated precision, as :func:`~.triplets.control` judges."""
    bl = dict(batch, feats=batch["feats"].float())
    with Products(bf16_weights(w), dtype):
        low = bigc.forward(w, m, bl)
        subj, obj, _, _ = triplets.served_tokens(trip, topk,
                                                 fwd["att"].device)
        own = low["att"].argmax(-1)
        logits = bigc.head(w, m, low, subj, obj, bl["cat_ids"]).float()
    probs, cats = torch.softmax(logits, -1).sort(-1, descending=True)
    with stated(w):
        att_gap, _, _ = triplets.gaps(w, m, batch, fwd, own[:, 0],
                                      own[:, 1], cats[..., :topk],
                                      probs[..., :topk], topk)
        _, logit_gap, score_gap = triplets.gaps(
            w, m, batch, fwd, subj, obj, cats[..., :topk],
            probs[..., :topk], topk)
    return {"att_gap": att_gap, "logit_gap": logit_gap,
            "score_gap": score_gap}
