"""Where a steady-state FuseTrack frame spends its time on the card.

    python -m vps_torch.profile [--frames 3] [--dcn-window R]

Builds PanopticFuseTrack at the R-50 `half-flow` preset with seeded random
weights (as chip_smoke.py does; ``--dcn-window R`` sets
``panoptic.dcn_window``, the windowed semantic head), runs two warm-up
frames, then profiles
``--frames`` steady-state frames with torch.profiler and prints: the frame
time on the host clock without and with the profiler, the device-busy share
of the profiled window (summed kernel time / wall time), device time per
predict stage (kernel time and host time of the named ranges in
PanopticFuseTrack.predict), the host syncs, the port's own kernels
(``vps_torch/csrc``) and the kernels with the most device time. The port's
kernels are launched through ctypes, outside any PyTorch op, and the
profiler links a kernel to a named range only through an op: the stage sums
leave them out, so they are listed on their own (correlation belongs to
flownet2 and fuse_neck, the windowed DCN to semantic_head). Needs a card;
TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vps_torch import zoo
from vps_torch.models.detectors import (
    PanopticFuseTrack,
    empty_track_state,
    predict_video,
    random_init_,
)

STAGES = ("backbone_fpn", "flownet2", "fuse_neck", "semantic_head", "rpn",
          "bbox_dets", "track", "mask_fusion")
# name parts of the kernels in vps_torch/csrc
PORT_KERNELS = ("corr_bf16_tc", "corr_f32", "dcw_fused", "dcw_mix", "sum_parts")


def _kernel_us(evt) -> float:
    """Summed duration of the kernels launched under a host event and its
    descendants."""
    return (sum(k.duration for k in evt.kernels)
            + sum(_kernel_us(c) for c in evt.cpu_children))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--dcn-window", type=int, default=None,
                    help="clamp the semantic head's DCN offsets to +-R and "
                         "run its windowed kernel (default: exact DCN)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vps_torch.profile needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = 1024, 2048

    cfg = zoo.fusetrack_model_cfg()
    cfg.pop("type")
    cfg["panoptic"]["dcn_window"] = args.dcn_window
    det = random_init_(PanopticFuseTrack(test_cfg=zoo.fusetrack_test_cfg(),
                                         device="cuda", **cfg), seed=0)
    rng = np.random.RandomState(0)
    n = 2 + 2 * args.frames
    frames = torch.from_numpy(rng.randn(n, 1, h, w, 3).astype(np.float32)).cuda()

    def run(lo, hi, carry):
        out, carry = predict_video(det, frames[lo:hi], [False] * (hi - lo),
                                   carry[0], carry[2], prev_feats=carry[1])
        torch.cuda.synchronize()
        return carry

    _, carry = predict_video(det, frames[:1], [True],
                             empty_track_state(256, device="cuda"), frames[0])
    carry = run(1, 2, carry)  # warm-up: first reset + one steady frame
    t0 = time.perf_counter()
    carry = run(2, 2 + args.frames, carry)
    plain_s = (time.perf_counter() - t0) / args.frames

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = run(2 + args.frames, n, carry)
        wall_s = time.perf_counter() - t0
    events = prof.events()
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in STAGES:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(kernels.values()) / (wall_s * 1e6)
    per = 1e3 * args.frames  # us -> ms per frame
    print(f"frame (dcn_window={args.dcn_window}): {plain_s * 1e3:.1f} ms "
          f"without the profiler, {wall_s / args.frames * 1e3:.1f} ms with it; "
          f"device busy {busy:.3f} of the profiled window ({args.frames} "
          f"frames, {h}x{w})")
    for name in STAGES:
        ranges = [e for e in events if e.name == name
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if ranges:
            print(f"stage {name:14s} kernels {sum(map(_kernel_us, ranges)) / per:8.2f}"
                  f" ms  host {sum(e.cpu_time_total for e in ranges) / per:8.2f}"
                  f" ms per frame")
    for name, us in sorted(kernels.items()):
        if any(part in name for part in PORT_KERNELS):
            count = sum(1 for e in events if e.name == name
                        and e.device_type == torch.autograd.DeviceType.CUDA)
            print(f"port kernel {us / per:8.4f} ms/frame  {count / args.frames:g} "
                  f"launches/frame  {name[:80]}")
    syncs = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    print(f"host syncs (item/bool/int of a device tensor): "
          f"{syncs / args.frames:g} per frame")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"kernel {us / per:8.2f} ms/frame  {name[:100]}")


if __name__ == "__main__":
    main()
