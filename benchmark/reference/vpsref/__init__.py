"""A frozen copy of the plain PyTorch modules of the port (``vps_torch``)
that the benchmark's cells run: the VPSNet family and the two-stage R-CNNs,
their ops, targets, samplers, train step and optimizer. Every hand-written
kernel of the port is replaced by its plain version (correlation,
deformable conv), ``inference_mode`` by ``no_grad`` (so that the FLOP
counter sees the ops), and nothing of the program is imported."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device asked for; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but "
                           "torch.cuda.is_available() is False")
    return dev
