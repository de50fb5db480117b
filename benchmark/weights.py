"""Seeded weights for a detector, made on its device in one draw.

The rules are those of the port's ``random_init_`` (activations O(1)
through the chain, a usable population of detections), read from module
class names and parameter names only, so that one function fills the
program's detector and the reference's copy alike: N(0, gain^2 / fan_in)
weights (gain 1.4, 1.0 for linear maps, 4.0 for the box classifiers), small
biases, norms near identity, the last norm of each residual branch x0.2,
small DCN offsets. Every value comes from one ``torch.randn`` over the
total size on a generator of the detector's device; each leaf is a slice
of it, scaled and shifted.
"""

from __future__ import annotations

import math
import re

import torch

NORMS = ("FrozenBatchNorm", "GroupNorm", "LayerNorm")
BLOCKS = ("Bottleneck", "BasicBlock")
# the box heads' classifiers
_CLS = r"^bbox_head\.(\d+\.)?fc_cls$"
# (pattern over the module name, gain); linear maps keep gain 1.0
GAINS = ((r"conv2?_offset$", 0.3), (_CLS, 4.0),
         (r"(fc|rpn)_reg$", 0.4),
         (r"^neck\.|rpn_cls$|conv_pred\.conv$", 1.0))
DEFAULT_GAIN = 1.4


def _rules(det):
    """(norm modules, residual-branch last norms, transposed convs)."""
    mods = dict(det.named_modules())
    norms = {n for n, m in mods.items() if type(m).__name__ in NORMS}
    residual = set()
    for n, m in det.backbone.named_modules():
        kind = type(m).__name__
        if kind in BLOCKS:
            residual.add(f"backbone.{n}.{'bn3' if kind == 'Bottleneck' else 'bn2'}")
    transposed = {n for n, m in mods.items()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    return norms, residual, transposed


def _leaf(name, p, z, norms, residual, transposed):
    """The value of leaf ``name`` (template ``p``) from its standard normal
    draw ``z``."""
    module, leaf = name.rsplit(".", 1)
    if leaf == "running_mean":
        return 0.1 * z
    if leaf == "running_var":
        return 1.0 + 0.1 * z.abs()
    if module in norms:
        if leaf != "weight":
            return 0.1 * z
        val = 1.0 + 0.1 * z
        return val * 0.2 if module in residual else val
    if leaf == "bias":
        return z * (1.0 if re.search(_CLS, module) else 0.02)
    fan_in = p[0].numel()
    if module in transposed:  # (in, out, kh, kw)
        fan_in = p.shape[0] * p[0, 0].numel()
    gain = next((g for pat, g in GAINS if re.search(pat, module)),
                DEFAULT_GAIN)
    return z * (gain / math.sqrt(fan_in))


@torch.no_grad()
def fill(det, seed: int, device) -> None:
    """Overwrite every parameter and buffer of ``det``'s state dict with
    the seeded values (integer buffers are left as they are)."""
    rules = _rules(det)
    state = {n: t for n, t in det.state_dict().items()
             if t.is_floating_point()}
    total = sum(t.numel() for t in state.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    draw = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, t in state.items():
        z = draw[at:at + t.numel()].view(t.shape)
        at += t.numel()
        t.copy_(_leaf(name, t, z, *rules).to(t.dtype))
