"""Where a steady-state FuseTrack frame spends its time on the card.

    python -m vps_torch.profile [--frames 3] [--dcn-window R]
        [--detector PanopticFuseTrack|PanopticFuse|PanopticTrack]

Builds the detector (PanopticFuseTrack unless ``--detector``; PanopticFuse
has no track head, PanopticTrack no flow and no fuse neck) at the R-50
`half-flow` preset with seeded random weights (as chip_smoke.py does;
``--dcn-window R`` sets ``panoptic.dcn_window``, the windowed semantic
head), runs two warm-up frames, then profiles
``--frames`` steady-state frames with torch.profiler and prints: the frame
time on the host clock without and with the profiler, the device-busy share
of the profiled window (summed kernel time / wall time), device time per
predict stage (kernel time and host time of the named ranges in
PanopticFuseTrack.predict, those the detector has), the host syncs, the port's own kernels
(``vps_torch/csrc``) and the kernels with the most device time. The port's
kernels are launched through ctypes, outside any PyTorch op, and the
profiler links a kernel to a named range only through an op: the stage sums
leave them out, so they are listed on their own (correlation belongs to
flownet2 and fuse_neck, the windowed DCN to semantic_head). Needs a card;
TF32 is off (``vps_torch.utils.numerics.f32_policy``).

``train_step`` does the same for one training step of a model the caller
built (chip_smoke.py's train phase calls it): the step split into forward,
backward and optimizer on the host clock, then one profiled step, read by
the named ranges of ``PanopticFuseTrack.loss`` (TRAIN_STAGES), the backward
(the autograd engine's ops) and the optimizer.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vps_torch import zoo
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    predict_video,
    random_init_,
)
from vps_torch.models.detectors.panoptic import PANOPTIC_DETECTORS
from vps_torch.utils.numerics import describe, f32_policy

STAGES = ("backbone_fpn", "flownet2", "fuse_neck", "semantic_head", "rpn",
          "bbox_dets", "track", "mask_fusion")
# the named ranges of PanopticFuseTrack.loss, then the two stages that
# train_step adds around the backward and the optimizer's update
TRAIN_STAGES = ("backbone_fpn", "flownet2", "fuse_neck", "semantic_head", "rpn",
                "proposal_targets", "bbox_head", "track", "mask_head",
                "panoptic_loss", "backward", "optimizer")
# name parts of the kernels in vps_torch/csrc
PORT_KERNELS = ("corr_bf16_tc", "corr_f32", "corr_backward", "dcw_fused",
                "dcw_mix", "sum_parts")


def stages_of(det, stages=STAGES):
    """The named ranges ``det`` runs: without a fuse neck no flownet2 or
    fuse_neck, without a track head no track."""
    absent = set()
    if det.extra_neck is None:
        absent |= {"flownet2", "fuse_neck"}
    if det.track_head is None:
        absent.add("track")
    return tuple(s for s in stages if s not in absent)


def _kernel_us(evt) -> float:
    """Summed duration of the kernels launched under a host event and its
    descendants."""
    return (sum(k.duration for k in evt.kernels)
            + sum(_kernel_us(c) for c in evt.cpu_children))


def _device_kernels(events, names):
    """Summed device time (us) per kernel name, the named ranges left out
    (their device-side copies would count twice)."""
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    return kernels


def _summary(events, kernels, stages, n, unit, prefix="", top=20):
    """Per-stage kernel and host ms, the port's kernels, the host syncs and
    the ``top`` kernels, each per ``unit`` (n of them in the profile)."""
    per = 1e3 * n  # us -> ms per unit
    for name in stages:
        ranges = [e for e in events if e.name == name
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if ranges:
            print(f"{prefix}stage {name:16s} kernels "
                  f"{sum(map(_kernel_us, ranges)) / per:8.2f} ms  host "
                  f"{sum(e.cpu_time_total for e in ranges) / per:8.2f} ms per {unit}")
    for name, us in sorted(kernels.items()):
        if any(part in name for part in PORT_KERNELS):
            count = sum(1 for e in events if e.name == name
                        and e.device_type == torch.autograd.DeviceType.CUDA)
            print(f"{prefix}port kernel {us / per:8.4f} ms/{unit}  {count / n:g} "
                  f"launches/{unit}  {name[:80]}")
    syncs = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    print(f"{prefix}host syncs (item/bool/int of a device tensor): "
          f"{syncs / n:g} per {unit}")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{prefix}kernel {us / per:8.2f} ms/{unit}  {name[:100]}")


def train_step(det, batch, optimizer, generator, prefix="train: ") -> None:
    """Two training steps of ``det`` on ``batch`` (a batch as the Runner's
    loaders yield it) with ``optimizer`` (vps_torch.train.optim): one split
    into forward (the loss), backward and optimizer on the host clock, each
    part ending in a synchronize; one under torch.profiler, printed as
    device busy (summed kernel time over the step's wall time, the
    profiler's overhead included), per-stage times, the port's kernels and
    the top kernels. The backward's kernels are those under the autograd
    engine's ops; the port's own kernels show only in their own lines."""
    from vps_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(det)
    rec = torch.profiler.record_function

    def step():
        t = [time.perf_counter()]
        total, _ = loss_fn(batch, generator)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with rec("backward"):
            total.backward()
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        with rec("optimizer"):
            optimizer.step()
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        return np.diff(t)

    fwd, bwd, opt = step()
    print(f"{prefix}one more step, split: forward (loss) {fwd:.4f}s, backward "
          f"{bwd:.4f}s, optimizer {opt:.4f}s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = float(sum(step()))
    events = prof.events()
    kernels = _device_kernels(events, TRAIN_STAGES)
    backward_us = sum(_kernel_us(e) for e in events
                      if e.name.startswith("autograd::engine::evaluate_function")
                      and e.device_type == torch.autograd.DeviceType.CPU)
    print(f"{prefix}one more step under torch.profiler: wall {wall_s:.4f}s, "
          f"kernels {sum(kernels.values()) / 1e3:.1f} ms, device busy "
          f"{sum(kernels.values()) / (wall_s * 1e6):.3f}; backward kernels "
          f"(autograd engine) {backward_us / 1e3:.1f} ms")
    _summary(events, kernels, stages_of(det, TRAIN_STAGES), 1, "step", prefix,
             top=8)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--dcn-window", type=int, default=None,
                    help="clamp the semantic head's DCN offsets to +-R and "
                         "run its windowed kernel (default: exact DCN)")
    ap.add_argument("--detector", default="PanopticFuseTrack",
                    choices=PANOPTIC_DETECTORS)
    args = ap.parse_args(argv)
    numerics = f32_policy()
    if not torch.cuda.is_available():
        raise SystemExit("vps_torch.profile needs an NVIDIA GPU")
    h, w = 1024, 2048

    cfg = zoo.fusetrack_model_cfg()
    cfg["type"] = args.detector
    if args.detector == "PanopticFuse":
        cfg["track_head"] = None
    elif args.detector == "PanopticTrack":
        cfg["extra_neck"] = None
    cfg["panoptic"]["dcn_window"] = args.dcn_window
    det = random_init_(build_detector(cfg, test_cfg=zoo.fusetrack_test_cfg(),
                                      device="cuda"), seed=0)
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
    kernels = _device_kernels(events, STAGES)
    busy = sum(kernels.values()) / (wall_s * 1e6)
    print(f"frame ({args.detector}, dcn_window={args.dcn_window}): "
          f"{plain_s * 1e3:.1f} ms "
          f"without the profiler, {wall_s / args.frames * 1e3:.1f} ms with it; "
          f"device busy {busy:.3f} of the profiled window ({args.frames} "
          f"frames, {h}x{w}); {describe(numerics)}")
    _summary(events, kernels, stages_of(det), args.frames, "frame")


if __name__ == "__main__":
    main()
