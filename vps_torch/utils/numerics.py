"""The port's one numerics policy: float32 work runs in full float32, as the
JAX reference computes it.

PyTorch lets the card run float32 matmuls and convolutions in TF32 (a 10-bit
mantissa) when its global flags allow it, and cuDNN's flag allows it by
default; results then differ from the reference's float32. Every entry
point calls ``f32_policy()`` before it builds a model. Importing
``vps_torch`` sets no flag.
"""

from __future__ import annotations

from typing import Dict

import torch


def f32_policy() -> Dict[str, bool]:
    """Switch TF32 off for matmuls and for cuDNN; return the settings as
    they now stand, for the caller to print beside its numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def describe(s: Dict[str, bool]) -> str:
    """The settings as one line of text."""
    return "numerics: " + ", ".join(f"{k}={v}" for k, v in s.items())
