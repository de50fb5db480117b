"""The port's numerics policies.

``f32_policy``: float32 work runs in full float32, as the JAX reference
computes it. PyTorch lets the card run float32 matmuls and convolutions in
TF32 (a 10-bit mantissa) when its global flags allow it, and cuDNN's flag
allows it by default; results then differ from the reference's float32.
Every entry point calls ``f32_policy()`` before it builds a model.

``inference_policy``: ``f32_policy`` and cuDNN held to deterministic
algorithms (no benchmark search), for repeatable inference: left free, cuDNN
picks non-deterministic algorithms for FlowNet2's transposed convolutions,
and two runs of one clip differ, where the reference replays exactly.
``test_vpq`` runs under it; ``predict_video`` and the trainer set nothing.

Importing ``vps_torch`` sets no flag.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch


def f32_policy() -> Dict[str, bool]:
    """Switch TF32 off for matmuls and for cuDNN; return the settings as
    they now stand, for the caller to print beside its numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


@contextlib.contextmanager
def inference_policy() -> Iterator[Dict[str, bool]]:
    """``f32_policy``, and cuDNN held to deterministic algorithms without the
    benchmark search while the context is open; yields the settings as they
    then stand. On exit cuDNN's two flags get back the values they had (TF32
    stays off), so a caller in the same process trains as before."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    settings = f32_policy()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield dict(settings, **{
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark})
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.backends.cudnn.benchmark = old[1]


def describe(s: Dict[str, bool]) -> str:
    """The settings as one line of text."""
    return "numerics: " + ", ".join(f"{k}={v}" for k, v in s.items())
