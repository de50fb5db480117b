"""Parameters and forward FLOPs of a detector (the port's counterpart of the
repo's ``tools/get_flops.py``).

    python -m vps_torch.tools.get_flops CONFIG [--shape 1024 2048]
        [--device cuda|cpu]

Parameters: the count of the built detector's ``nn.Parameter`` elements,
the frozen ones included. FLOPs: one ``predict`` of a zero image at
``--shape`` (the panoptic detectors with the image as its own reference
frame and an empty track state of 256, as the JAX tool runs it), seeded
random weights, counted by ``torch.utils.flop_counter.FlopCounterMode``,
which counts matmuls, convolutions and attention (2 per multiply-add) and
no elementwise op, where XLA's cost analysis counts those too. The port's
kernels launch through ctypes, outside any PyTorch op, so the counter
cannot see them (and the CPU's plain correlation is elementwise): each
correlation call adds its own 2 * C * D^2 * H * W (a multiply and an add
per channel, displacement and pixel, times the batch), printed on a line of
its own and included in the total. Detection counts, and with them the RoI
heads' work, depend on the weights: the run counts what this one ran.
"""

from __future__ import annotations

import argparse
import torch

from vps_torch import resolve_device


def count_params(det) -> int:
    return sum(p.numel() for p in det.parameters())


def correlation_flops(shape, max_displacement, stride2=1) -> float:
    """2 * B * H * W * D^2 * C for f1 of ``shape`` (B, H, W, C): the cost
    volume's multiply-adds."""
    b, h, w, c = shape
    d = 2 * (max_displacement // stride2) + 1
    return 2.0 * b * h * w * d * d * c


def count_flops(det, h, w):
    """One predict at h x w under the counter: (the counter, the correlation
    calls as (shape, max_displacement, stride2, flops), recorded by the
    correlation's wrapper)."""
    from torch.utils.flop_counter import FlopCounterMode

    from vps_torch.models.detectors import empty_track_state
    from vps_torch.models.detectors.panoptic import PANOPTIC_DETECTORS
    from vps_torch.ops.correlation import record_calls

    img = torch.zeros((1, h, w, 3), device=det.device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), record_calls() as calls, counter:
        if type(det).__name__ in PANOPTIC_DETECTORS:
            det.predict(img, img, empty_track_state(256, device=det.device))
        else:
            det.predict(img)
    return counter, [c + (correlation_flops(*c),) for c in calls]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Parameters and forward FLOPs")
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=2, default=[1024, 2048])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Prints the numbers; returns them (``params``, ``flops``, the
    counter's ``counted`` and the correlation's ``correlation`` flops,
    ``by_module``: the counter's flops by module name)."""
    args = parse_args(argv)
    from vps_torch.config import Config
    from vps_torch.models.detectors import build_detector, random_init_
    from vps_torch.utils.numerics import describe, f32_policy

    numerics = f32_policy()
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    det = random_init_(build_detector(cfg.model, cfg.get("train_cfg"),
                                      cfg.get("test_cfg"), device), seed=0)
    det.eval()
    n_params = count_params(det)
    print(f"params: {n_params / 1e6:.2f} M")
    h, w = args.shape
    counter, calls = count_flops(det, h, w)
    counted = float(counter.get_total_flops())
    corr = sum(c[-1] for c in calls)
    flops = counted + corr
    print(f"forward flops: {flops / 1e9:.2f} GFLOPs @ {h}x{w} on {device}")
    print(f"  of which the port's correlation kernels: {corr / 1e9:.2f} "
          f"GFLOPs over {len(calls)} calls (2*C*D^2*H*W each: "
          + ", ".join(f"{s} md {md} s2 {s2}" for s, md, s2, _ in calls)
          + "); the kernels launch outside any PyTorch op, so these are "
          "added by hand")
    print("  counted by FlopCounterMode: matmuls, convolutions and attention "
          "(2 per multiply-add); elementwise ops, which XLA's cost analysis "
          f"counts, are not; {describe(numerics)}")
    by_module = {name: float(sum(ops.values()))
                 for name, ops in counter.get_flop_counts().items()}
    return dict(params=n_params, flops=flops, counted=counted,
                correlation=corr, correlation_calls=calls,
                by_module=by_module)


if __name__ == "__main__":
    main()
