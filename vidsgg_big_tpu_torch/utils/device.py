"""Device selection for the port's entry points."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name``; the default is the card.

    Raises instead of carrying on silently on the CPU when CUDA was asked
    for and is absent: the CPU runs only when the caller names it.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device


def strict_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN convolutions default to TF32 (about three decimal digits), which
    loses float32 parity with the JAX reference; matmuls are set explicitly
    too so a caller's global setting cannot leak in.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_name_and_power() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them
    (a card below its 700 W maximum runs slower under load, so every
    measurement is written down beside this)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
