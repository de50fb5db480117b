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
``test_vpq`` runs under it; ``predict_video`` sets nothing.

``train_policy``: ``inference_policy`` plus
``torch.use_deterministic_algorithms(True)``, for a train step that repeats
bit for bit, as JAX's does: ``index_add_`` and its kin take PyTorch's
deterministic path, and the two ops that have none on the card
(``grid_sample``'s and ``adaptive_max_pool2d``'s backwards) take the port's
own (``vps_torch.ops.warp``, ``vps_torch.models.layers``). ``Runner.run``
trains under it. cuBLAS is deterministic only with
``CUBLAS_WORKSPACE_CONFIG`` set before its first handle is made:
``deterministic_cublas`` sets it while CUDA is untouched and raises after.

Importing ``vps_torch`` sets no flag.
"""

from __future__ import annotations

import contextlib
import os
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


CUBLAS_WORKSPACE = ":4096:8"
_DETERMINISTIC_WORKSPACES = (":4096:8", ":16:8")


def deterministic_cublas() -> str:
    """See that cuBLAS runs deterministically: ``CUBLAS_WORKSPACE_CONFIG``
    must name one of cuBLAS's deterministic workspaces before the process
    makes its first cuBLAS handle. Sets it (to ``:4096:8``) while CUDA is
    not yet initialised; raises if it is missing once CUDA is. Returns the
    value. An entry point that trains calls this before it builds a model
    on the card."""
    value = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if value in _DETERMINISTIC_WORKSPACES:
        return value
    if torch.cuda.is_initialized():
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG={value!r}: deterministic training needs "
            f"{CUBLAS_WORKSPACE} (or :16:8) set before the process first uses "
            f"CUDA; call vps_torch.utils.numerics.deterministic_cublas() "
            f"first, or set it in the environment")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    return CUBLAS_WORKSPACE


@contextlib.contextmanager
def train_policy() -> Iterator[Dict[str, bool]]:
    """``inference_policy``'s settings and
    ``torch.use_deterministic_algorithms(True)`` while the context is open,
    after ``deterministic_cublas`` (which raises rather than train without
    the mode); yields the settings as they then stand. On exit every flag
    it set gets back the value it had (TF32 stays off)."""
    workspace = deterministic_cublas()
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    settings = f32_policy()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        yield dict(settings, **{
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "deterministic_algorithms":
                torch.are_deterministic_algorithms_enabled(),
            "CUBLAS_WORKSPACE_CONFIG": workspace})
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.backends.cudnn.benchmark = old[1]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])


def describe(s: Dict[str, bool]) -> str:
    """The settings as one line of text."""
    return "numerics: " + ", ".join(f"{k}={v}" for k, v in s.items())
