"""Convert a reference PyTorch checkpoint into a port checkpoint, with no
JAX.

Counterpart of the JAX package's ``tools/convert_checkpoint.py``.  The
port's modules keep the reference's parameter names and layouts, so the
conversion is a prefix strip (``module.`` of DataParallel), optionally the
reference's historical renames (``--legacy_keys``), and a ``strict=True``
load into the port's model of ``--model`` on ``--cfg_path``, where a wrong
name fails loudly.  Run as

    python -m vidsgg_big_tpu_torch.tools.convert_checkpoint \\
        --torch_ckpt model_epoch_80.pth --cfg_path experiments/exp2/config_.py \\
        --model bigc_vidvrd --out experiments/exp2/converted_ckpt

It writes ``ckpt_0.pt`` in ``train/train_state.save_checkpoint``'s format
(step 0, a fresh Adam state), which ``eval_* --ckpt_path OUT`` serves and
``train_* --from_checkpoint --ckpt_path OUT`` resumes, and ``tables.npz``
with the frozen tables that JAX's ``bigc_params_from_torch`` /
``basec_params_from_torch`` return (``enti_name_emb``, and v7's
``pos_emb_table``), which ``--tables_path`` reads.  The input is a raw
``state_dict`` or the reference's training dict (``model_state_dict``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.base_c import BaseCConfig
from ..models.big_c import BigCConfig
from ..models.grounding import GroundingConfig
from ..models.transplant import strip_module_prefix
from ..train.train_state import TrainState, save_checkpoint
from ..utils.config import parse_config_py
from .eval_vidor import build_basec_model, build_grounding_model
from .eval_vidvrd import build_model

MODELS = ("bigc_vidvrd", "bigc_vidor", "base_c", "grounding")


def replace_legacy_keys(sd):
    """Historical reference key scheme -> released scheme (reference
    tools/eval_vidvrd_our_gt.py:186-207)."""
    out = {}
    for name, v in sd.items():
        if name == "pred_nodes_init":
            name = "pred_query_init"
        name = name.replace("fc_msg_recv", "fc_rolewise")
        name = name.replace(".layers.", ".")
        name = name.replace("fc_pred2logits.0", "fc_pred2logits")
        out[name] = v
    return out


def load_reference_state(path: str, legacy_keys: bool = False) -> dict:
    """The reference-named ``state_dict`` in ``path`` (a raw one, or under
    ``model_state_dict``), ``module.`` prefixes stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) \
        else ckpt
    sd = strip_module_prefix(sd)
    return replace_legacy_keys(sd) if legacy_keys else sd


def build(model_name: str, model_config: dict) -> torch.nn.Module:
    """The port's model of ``model_name`` on ``model_config``, on the
    CPU."""
    if model_name in ("bigc_vidvrd", "bigc_vidor"):
        variant = "v10" if model_name == "bigc_vidvrd" else "v7"
        return build_model(BigCConfig.from_dict(model_config,
                                                variant=variant),
                           model_config)
    if model_name == "base_c":
        return build_basec_model(BaseCConfig.from_dict(model_config),
                                 model_config)
    return build_grounding_model(GroundingConfig.from_dict(model_config))


def tables_of(model_name: str, sd: dict) -> dict:
    """The frozen tables of JAX's transplant, None where absent."""
    def arr(k):
        return (np.asarray(sd[k].detach().cpu().numpy(), np.float32)
                if k in sd else None)
    if model_name == "grounding":
        return {}
    tables = {"enti_name_emb": arr("EntiNameEmb")}
    if model_name != "base_c":
        tables["pos_emb_table"] = (arr("pos_embedding")
                                   if model_name == "bigc_vidor" else None)
    return tables


def main(argv=None) -> dict:
    """Convert; returns {"out", "n_tensors", "n_params", "tables"}."""
    args = parse_args(argv)
    sd = load_reference_state(args.torch_ckpt, args.legacy_keys)
    model_config = parse_config_py(args.cfg_path)["model_config"]
    model = build(args.model, model_config)
    model.load_state_dict(sd, strict=True)

    out = os.path.abspath(args.out)
    save_checkpoint(out, TrainState(model, 1e-4, 0.2, [1]), step=0)
    tables = {k: v for k, v in tables_of(args.model, sd).items()
              if v is not None}
    if tables:
        np.savez(os.path.join(out, "tables.npz"), **tables)
    n_params = sum(v.numel() for v in sd.values())
    print(f"converted {args.torch_ckpt} -> {out} ({args.model}, "
          f"{len(sd)} tensors, {n_params / 1e6:.2f}M values"
          f"{', tables: ' + ','.join(tables) if tables else ''})")
    return {"out": out, "n_tensors": len(sd), "n_params": n_params,
            "tables": sorted(tables)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--torch_ckpt", type=str, required=True)
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--model", type=str, required=True, choices=MODELS)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--legacy_keys", action="store_true",
                        help="apply the reference's historical key renames "
                             "before the load")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
