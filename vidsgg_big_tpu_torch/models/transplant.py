"""JAX-parameter -> port ``state_dict`` conversion (BIG-C, Base-C,
grounding and the segment baseline).

The exact inverses of ``bigc_params_from_torch``,
``basec_params_from_torch`` and ``grounding_params_from_torch`` in the JAX
package's ``models/transplant.py`` (:79, :151-172, :224):
the port keeps the reference torch parameter names and layouts, so these
are layout conversions only.

  * Dense kernel (in, out)          -> ``nn.Linear`` weight (out, in)
  * Conv kernel (k, in, out)        -> ``nn.Conv1d`` weight (out, in, k)
  * per-head q/k/v kernels (D, h, hd) -> packed ``in_proj_weight`` (3D, D);
    out kernel (h, hd, D)           -> ``out_proj.weight`` (D, D)
  * LayerNorm scale/bias            -> weight/bias
  * MLP dense{0, 1, ...}            -> ``nn.Sequential`` indices {0, 2, ...}
  * ``fc_enti2enco``: the JAX model flattens the pooled node tensor
    bin-major, the reference channel-major; the first layer's input rows
    are permuted back.
  * grounding: depthwise/pointwise conv kernels (k, in/groups, out) ->
    (out, in/groups, k); QANet ``attn_{q,k,v,out}`` -> packed ``mh_attn``;
    conv heads ``conv{i}`` / ``out`` -> ``{i}.0`` / ``4``.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import sine_pos_embedding


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _mlp(out, prefix, p, torch_ids):
    for k, t in enumerate(torch_ids):
        _dense(out, f"{prefix}.{t}", p[f"dense{k}"])


def _layernorm(out, name, p):
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _mha(out, prefix, p):
    d = np.asarray(p["q"]["kernel"]).shape[0]
    out[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(p[nm]["kernel"]).reshape(d, d).T for nm in "qkv"]))
    out[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(p[nm]["bias"]).reshape(d) for nm in "qkv"]))
    out[f"{prefix}.out_proj.weight"] = _t(
        np.asarray(p["out"]["kernel"]).reshape(d, d).T)
    out[f"{prefix}.out_proj.bias"] = _t(p["out"]["bias"])


def _enti2enco(out, p, cfg):
    e, pool = cfg.dim_enti, cfg.enco_pool_len
    k = np.asarray(p["dense0"]["kernel"])            # (pool*E, E) bin-major
    p = dict(p, dense0=dict(p["dense0"], kernel=k.reshape(
        pool, e, -1).transpose(1, 0, 2).reshape(e * pool, -1)))
    _mlp(out, "fc_enti2enco", p, (0, 2))


def bigc_state_dict_from_jax(params, cfg, tables=None):
    """Port ``state_dict`` of :class:`BigC` from the JAX ``{"params": ...}``
    tree (numpy or JAX arrays) of a v10 or v7 model.

    ``tables`` is the ``{"enti_name_emb": ..., "pos_emb_table": ...}`` dict
    that ``bigc_params_from_torch`` returns beside the params.  A missing
    name table gives a zero ``EntiNameEmb`` buffer, as the JAX CLIs use; a
    v7 model without ``pos_emb_table`` has the sine table, as the JAX model.
    """
    tables = tables or {}
    p = params["params"]
    te = p["tracklet_encoder"]
    out = {}
    _tracklet_encoder(out, te, cfg)
    for i in range(cfg.n_enco_layers):
        src, t = p[f"encoder{i}"], f"encoder_layers.{i}"
        _mha(out, f"{t}.self_attn", src["self_attn"])
        _dense(out, f"{t}.linear1", src["linear1"])
        _dense(out, f"{t}.linear2", src["linear2"])
        _layernorm(out, f"{t}.norm1", src["norm1"])
        _layernorm(out, f"{t}.norm2", src["norm2"])
    for i in range(cfg.n_deco_layers):
        src, t = p[f"decoder{i}"], f"decoder_layers.{i}"
        _mha(out, f"{t}.self_attn", src["self_attn"])
        _layernorm(out, f"{t}.norm1", src["norm1"])
        _dense(out, f"{t}.fc_enti2att", src["fc_enti2att"])
        _dense(out, f"{t}.fc_pred2att", src["fc_pred2att"])
        _mlp(out, f"{t}.fc_rolewise.0", src["fc_rolewise0"], (0, 2))
        _mlp(out, f"{t}.fc_rolewise.1", src["fc_rolewise1"], (0, 2))
        _layernorm(out, f"{t}.norm2", src["norm2"])
        _dense(out, f"{t}.fc2.0", src["fc2_0"])
        _dense(out, f"{t}.fc2.3", src["fc2_1"])
        _layernorm(out, f"{t}.norm3", src["norm3"])
    out["pred_query_init"] = _t(p["pred_query_init"])
    out["bias_matrix"] = _t(p["bias_matrix"])
    if cfg.dim_i3d:
        _mlp(out, "fc_i3d", p["fc_i3d"], (0,))
    if cfg.variant == "v7":
        pos = tables.get("pos_emb_table")
        out["pos_embedding"] = _t(pos if pos is not None else
                                  sine_pos_embedding(cfg.num_querys,
                                                     cfg.dim_pred))
        _mlp(out, "fc_pred2logits", p["fc_pred2logits"], (0, 2))
    else:
        out["pos_embedding"] = _t(p["pos_embedding"])
        _dense(out, "fc_pred2logits", p["fc_pred2logits"])
    if cfg.name_emb_in_head:
        emb = tables.get("enti_name_emb")
        out["EntiNameEmb"] = (_t(emb) if emb is not None else
                              torch.zeros(cfg.num_enti_cats, cfg.dim_clsme))
    return out


def _tracklet_encoder(out, te, cfg):
    """The encoder layers shared by BIG-C and Base-C, at the top level."""
    _mlp(out, "fc_bbox2enti", te["fc_bbox2enti"], (0, 2))
    _mlp(out, "fc_feat2enti", te["fc_feat2enti"], (0, 2))
    out["conv_feat2enti.weight"] = _t(
        np.asarray(te["conv_feat2enti"]["kernel"]).transpose(2, 1, 0))
    out["conv_feat2enti.bias"] = _t(te["conv_feat2enti"]["bias"])
    _enti2enco(out, te["fc_enti2enco"], cfg)


def basec_state_dict_from_jax(params, cfg, tables=None):
    """Port ``state_dict`` of :class:`BaseC` from the JAX ``{"params":
    ...}`` tree; the inverse of ``basec_params_from_torch``, the encoder's
    channel-major pooled flatten included.  ``tables`` is the
    ``{"enti_name_emb": ...}`` dict returned beside the params: a
    name-embedding head without it gets a zero ``EntiNameEmb``."""
    tables = tables or {}
    p = params["params"]
    out = {}
    _tracklet_encoder(out, p["tracklet_encoder"], cfg)
    out["bias_matrix"] = _t(p["bias_matrix"])
    _mlp(out, "fc_pred2logits", p["fc_pred2logits"], (0, 2))
    if cfg.use_clsme and cfg.use_name_emb:
        emb = tables.get("enti_name_emb")
        out["EntiNameEmb"] = (_t(emb) if emb is not None else
                              torch.zeros(cfg.num_enti_cats, cfg.dim_clsme))
    return out


def _dwconv(out, prefix, p):
    for nm in ("depth_wise", "point_wise"):
        out[f"{prefix}.{nm}.weight"] = _t(
            np.asarray(p[nm]["kernel"]).transpose(2, 1, 0))
        out[f"{prefix}.{nm}.bias"] = _t(p[nm]["bias"])


def _qanet_layer(out, prefix, p, num_conv=4):
    _layernorm(out, f"{prefix}.normb", p["normb"])
    _layernorm(out, f"{prefix}.norme", p["norme"])
    _dense(out, f"{prefix}.fc", p["fc"])
    _mha(out, f"{prefix}.mh_attn", {"q": p["attn_q"], "k": p["attn_k"],
                                    "v": p["attn_v"], "out": p["attn_out"]})
    for i in range(num_conv):
        _dwconv(out, f"{prefix}.convs.{i}", p[f"conv{i}"])
        _layernorm(out, f"{prefix}.norm_seq.{i}", p[f"norm{i}"])


def grounding_state_dict_from_jax(params):
    """Port ``state_dict`` of :class:`GroundingModel` from the JAX
    ``{"params": ...}`` tree; the inverse of ``grounding_params_from_torch``.
    The name tables are trainable parameters on both sides."""
    p = params["params"]
    out = {"EntiNameEmb": _t(p["EntiNameEmb"]),
           "PredNameEmb": _t(p["PredNameEmb"])}
    for name in ("video_fc", "query_fc", "temp_fc", "vq_fc"):
        _dense(out, name, p[name])
    out["proj2sim.weight"] = _t(np.asarray(p["proj2sim"]["kernel"]).T)
    for name in ("video_encoder", "query_encoder", "combined_encoder"):
        _qanet_layer(out, name, p[name])
    for name in ("cls_head", "conf_head", "regr_head"):
        for i in range(4):
            _dwconv(out, f"{name}.{i}.0", p[name][f"conv{i}"])
        _dwconv(out, f"{name}.4", p[name]["out"])
    return out


def segment_baseline_state_dict_from_jax(params):
    """Port ``state_dict`` of :class:`SegmentBaseline` from the JAX
    ``{"params": {"pred_fc": {"kernel", "bias"}}}`` tree (also the layout of
    ``segment_baseline_weights.npz``): ``weight = kernel.T``."""
    out = {}
    _dense(out, "pred_fc", params["params"]["pred_fc"])
    return out


def strip_module_prefix(state_dict):
    """Remove DataParallel ``module.`` prefixes (reference
    tools/eval_vidvrd.py:82-87)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}
