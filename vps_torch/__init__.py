"""PyTorch + CUDA port of vps_tpu's FuseTrack, video inference and
training, for one NVIDIA H100.

Layout mirrors ``vps_tpu`` (``ops/``, ``models/``, ``models/flow/``,
``models/detectors/``, ``core/``, ``train/``, ``utils/``, ``data/``,
``eval/``) so every module has a counterpart under the same name; the
entry points are ``tools/`` (train, test_vpq, eval_vpq), the configs
``configs/``, and hand-written Hopper kernels live in ``csrc/``. The
package imports torch, numpy, cv2, PIL and the standard library only.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    A CUDA request without a card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vps_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
