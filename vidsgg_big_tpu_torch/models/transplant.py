"""JAX-parameter -> port ``state_dict`` conversion for BIG-C v10.

The exact inverse of ``bigc_params_from_torch`` in the JAX package's
``models/transplant.py``: the port keeps the reference torch parameter
names and layouts, so these are layout conversions only.

  * Dense kernel (in, out)          -> ``nn.Linear`` weight (out, in)
  * Conv kernel (k, in, out)        -> ``nn.Conv1d`` weight (out, in, k)
  * per-head q/k/v kernels (D, h, hd) -> packed ``in_proj_weight`` (3D, D);
    out kernel (h, hd, D)           -> ``out_proj.weight`` (D, D)
  * LayerNorm scale/bias            -> weight/bias
  * MLP dense{0, 1, ...}            -> ``nn.Sequential`` indices {0, 2, ...}
  * ``fc_enti2enco``: the JAX model flattens the pooled node tensor
    bin-major, the reference channel-major; the first layer's input rows
    are permuted back.
"""
from __future__ import annotations

import numpy as np
import torch


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
    tree (numpy or JAX arrays) of a v10 model.

    ``tables`` is the ``{"enti_name_emb": ...}`` dict that
    ``bigc_params_from_torch`` returns beside the params; a missing table
    gives a zero ``EntiNameEmb`` buffer, as the JAX CLIs use.
    """
    if cfg.variant != "v10":
        raise NotImplementedError("only BIG-C v10 is ported (v7: ROADMAP A7)")
    p = params["params"]
    te = p["tracklet_encoder"]
    out = {}
    _mlp(out, "fc_bbox2enti", te["fc_bbox2enti"], (0, 2))
    _mlp(out, "fc_feat2enti", te["fc_feat2enti"], (0, 2))
    out["conv_feat2enti.weight"] = _t(
        np.asarray(te["conv_feat2enti"]["kernel"]).transpose(2, 1, 0))
    out["conv_feat2enti.bias"] = _t(te["conv_feat2enti"]["bias"])
    _enti2enco(out, te["fc_enti2enco"], cfg)
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
    out["pos_embedding"] = _t(p["pos_embedding"])
    out["bias_matrix"] = _t(p["bias_matrix"])
    if cfg.dim_i3d:
        _mlp(out, "fc_i3d", p["fc_i3d"], (0,))
    _dense(out, "fc_pred2logits", p["fc_pred2logits"])
    emb = (tables or {}).get("enti_name_emb")
    out["EntiNameEmb"] = (_t(emb) if emb is not None else
                          torch.zeros(cfg.num_enti_cats, cfg.dim_clsme))
    return out


def strip_module_prefix(state_dict):
    """Remove DataParallel ``module.`` prefixes (reference
    tools/eval_vidvrd.py:82-87)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}
