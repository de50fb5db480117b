"""FLOPs of a frame, a step or an image, counted on the plain reference.

``Counter`` is a dispatch mode: every matrix product and convolution the
reference runs (forward and backward) adds its FLOPs, as
``torch.utils.flop_counter`` counts them from shapes, to the bucket of the
precision the configuration sets for the tower that runs it: bfloat16 for
an op on bf16 tensors or inside a module whose ``compute_dtype`` is bf16,
float32 otherwise. The reference's correlations are elementwise products
that no such op carries: their 2*B*H*W*D^2*C (forward) and 4*B*H*W*D^2*C
(backward, for the differentiated calls) are added from the shapes the
reference records. The count depends on the configuration and the input
shapes only, never on which implementation the program ran.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from roofline import PEAK_FLOPS


def correlation_flops(shape, md, s2, backward=False) -> float:
    b, h, w, c = shape
    d2 = (2 * (md // s2) + 1) ** 2
    return (4.0 if backward else 2.0) * b * h * w * d2 * c


class Counter(TorchDispatchMode):
    """FLOPs by precision bucket while open (``flops``: {dtype name: n})."""

    def __init__(self, model=None):
        super().__init__()
        self.flops = {"bfloat16": 0.0, "float32": 0.0}
        self._bf16_depth = 0
        self._paused = False
        self._hooks = []
        if model is not None:
            for m in model.modules():
                if getattr(m, "compute_dtype", None) == torch.bfloat16:
                    self._hooks.append(m.register_forward_pre_hook(self._enter))
                    self._hooks.append(m.register_forward_hook(self._leave))

    def _enter(self, *_):
        self._bf16_depth += 1

    def _leave(self, *_):
        self._bf16_depth -= 1

    @contextlib.contextmanager
    def paused(self):
        """While open, ops run uncounted."""
        self._paused = True
        try:
            yield
        finally:
            self._paused = False

    def close(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry and not self._paused:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            bf16 = self._bf16_depth > 0 or any(
                isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                for a in args)
            self.flops["bfloat16" if bf16 else "float32"] += float(n)
        return out


def least_seconds(flops: dict) -> float:
    """Seconds the card needs at its peaks for ``flops`` by bucket."""
    return sum(n / PEAK_FLOPS[k] for k, n in flops.items())
