"""Load serving artifacts written by ``tools/export_model.py``.

Port of the JAX package's ``utils/serving.py``.  The artifact is a
``torch.export`` program: the whole infer step with its weights, run
without the model's Python code.  Its kernels are the registered ops of
``ops/role_attn.py``, ``ops/composed_attn.py`` and ``ops/dwsep_conv.py``,
which are imported here before the program is loaded.

    from vidsgg_big_tpu_torch.utils.serving import load_exported
    serve, manifest = load_exported("exp2_serving")
    triplets = serve(batch)   # a TrackletBatch at the manifest's shapes,
                              # on the device the artifact was exported on
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

ARTIFACT = "model.pt2"     # the program's file in an export directory


def flat_leaves(batch) -> list:
    """The flat-leaf calling convention of an artifact: a batch
    dataclass's fields in order (None skipped), or a tuple's items."""
    if dataclasses.is_dataclass(batch):
        return [getattr(batch, f.name) for f in dataclasses.fields(batch)
                if getattr(batch, f.name) is not None]
    return list(batch)


def load_exported(path: str):
    """Returns ``(call, manifest)`` for an export directory (or a bare
    ``.pt2`` file, in which case manifest is None).

    ``call`` takes the packed input batch (a TrackletBatch, or a tuple whose
    items are the exported inputs in order, grounding's operands) and
    returns the model's output, rebuilt into the exported output type
    (Triplets for the BIG-C and Base-C exports) through the manifest, or
    the raw tuple of output leaves where that type cannot be imported.  JAX's
    ``jit=`` argument has no counterpart: the program runs as it was
    exported, with no compile step of its own.  Where the kernels'
    libraries are built is the caller's choice
    (``utils/compile_cache.enable_compilation_cache``); loading leaves it
    as it is.
    """
    import torch

    # the kernels' ops must be registered before the program is loaded
    from ..ops import composed_attn, dwsep_conv, role_attn  # noqa: F401

    if os.path.isdir(path):
        blob_path = os.path.join(path, ARTIFACT)
        man_path = os.path.join(path, "manifest.json")
        manifest = None
        if os.path.exists(man_path):
            with open(man_path) as f:
                manifest = json.load(f)
    else:
        blob_path, manifest = path, None
    fn = torch.export.load(blob_path).module()

    out_cls = None
    if manifest and manifest.get("output_type"):
        mod, _, qual = manifest["output_type"].rpartition(".")
        try:
            out_cls = getattr(importlib.import_module(mod), qual)
        except (ImportError, AttributeError):
            out_cls = None

    def call(batch):
        with torch.inference_mode():      # as the live infer steps
            out = fn(*flat_leaves(batch))
        if out_cls is not None:
            return out_cls(**dict(zip(manifest["output_fields"], out)))
        return out

    return call, manifest
