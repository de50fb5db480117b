"""Where a steady-state FuseTrack frame spends its time on the card.

    python -m vps_torch.profile [--frames 3] [--dcn-window R]
        [--detector PanopticFuseTrack|PanopticFuse|PanopticTrack]
        [--preset half-flow] [--size 1024x2048] [--device cuda|cpu]

Builds the detector (PanopticFuseTrack unless ``--detector``; PanopticFuse
has no track head, PanopticTrack no flow and no fuse neck) at the R-50
``--preset`` (``zoo.PRESETS``; `half-flow` unless given) with seeded random
weights (as chip_smoke.py does; ``--dcn-window R`` sets
``panoptic.dcn_window``, the windowed semantic head), over seeded frames of
``--size`` (1024x2048 unless given), runs two warm-up frames, then profiles
``--frames`` steady-state frames with torch.profiler and prints: the frame
time on the host clock without and with the profiler, the device-busy share
of the profiled window (summed kernel time / wall time), device time per
predict stage (kernel time and host time of the named ranges in
PanopticFuseTrack.predict, those the detector has), the host syncs, the port's own kernels
(``vps_torch/csrc``) and the kernels with the most device time. The port's
kernels are launched through ctypes, outside any PyTorch op, and the
profiler links a kernel to a named range only through an op: the stage sums
leave them out, so they are listed on their own (correlation belongs to
flownet2 and fuse_neck, the windowed DCN to semantic_head). Runs on the
card unless ``--device cpu`` (then the profile holds host times only);
TF32 is off (``vps_torch.utils.numerics.f32_policy``).
``vps_torch/tools/profile_sections.py`` is the same run under the repo
tool's flags.

``train_step`` does the same for one training step of a model the caller
built (chip_smoke.py's train phase calls it): the step split into forward,
backward and optimizer on the host clock, then one profiled step, read by
the named ranges of ``PanopticFuseTrack.loss`` (TRAIN_STAGES), the backward
(the autograd engine's ops) and the optimizer.
"""

from __future__ import annotations

import argparse
import bisect
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vps_torch import resolve_device, zoo
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
# the autograd engine's op of each backward node
ENGINE = "autograd::engine::evaluate_function"
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


class Profile(NamedTuple):
    """What ``read_profile`` takes out of a profile."""

    kernels: Dict[str, float]  # device us by kernel name
    launches: Dict[str, int]  # kernel events by name
    ranges: Dict[str, Tuple[float, float]]  # kernel us, host us by range
    syncs: int  # item/bool/int of a device tensor


def read_profile(prof, stages) -> Profile:
    """The kineto events of ``prof`` read without building torch's event
    tree (``prof.events()`` took a minute for the ~700k events of a step
    through a DCN backbone): device time and count by kernel name, the
    named ranges' device-side copies left out; for each range of
    ``stages``, and for the autograd engine's ops together as ENGINE, the
    summed kernel time (a kernel counts for a range when the op that
    launched it started inside the range, on its thread: what torch's tree
    of children holds) and host time; the host syncs."""
    ops, spans, kernels, syncs = {}, [], [], 0
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), e.device_type()
        if dev == torch.autograd.DeviceType.CPU:
            tid, t0 = e.start_thread_id(), e.start_ns()
            ops[e.correlation_id()] = (tid, t0)
            key = (name if name in stages else
                   ENGINE if name.startswith(ENGINE) else None)
            if key is not None:
                spans.append((key, tid, t0, t0 + e.duration_ns()))
            elif name == "aten::_local_scalar_dense":
                syncs += 1
        elif dev == torch.autograd.DeviceType.CUDA and name not in stages:
            kernels.append((name, e.duration_ns(), e.linked_correlation_id()))
    by_thread = {}  # launch times, sorted, and running sums of durations
    for _, dur, corr in kernels:
        if corr in ops:
            tid, t0 = ops[corr]
            by_thread.setdefault(tid, []).append((t0, dur))
    for tid, launches in by_thread.items():
        launches.sort()
        acc = [0]
        for _, dur in launches:
            acc.append(acc[-1] + dur)
        by_thread[tid] = ([t for t, _ in launches], acc)
    ranges = {}
    for key, tid, t0, t1 in spans:
        k, h = ranges.get(key, (0.0, 0.0))
        if tid in by_thread:
            starts, acc = by_thread[tid]
            k += (acc[bisect.bisect_right(starts, t1)]
                  - acc[bisect.bisect_left(starts, t0)]) / 1e3
        ranges[key] = (k, h + (t1 - t0) / 1e3)
    device, launches = {}, {}
    for name, dur, _ in kernels:
        device[name] = device.get(name, 0.0) + dur / 1e3
        launches[name] = launches.get(name, 0) + 1
    return Profile(device, launches, ranges, syncs)


def _summary(p: Profile, stages, n, unit, prefix="", top=20):
    """Per-stage kernel and host ms, the port's kernels, the host syncs and
    the ``top`` kernels of ``p``, each per ``unit`` (n of them in the
    profile)."""
    per = 1e3 * n  # us -> ms per unit
    for name in stages:
        if name in p.ranges:
            k, h = p.ranges[name]
            print(f"{prefix}stage {name:16s} kernels {k / per:8.2f} ms  host "
                  f"{h / per:8.2f} ms per {unit}")
    for name, us in sorted(p.kernels.items()):
        if any(part in name for part in PORT_KERNELS):
            print(f"{prefix}port kernel {us / per:8.4f} ms/{unit}  "
                  f"{p.launches[name] / n:g} launches/{unit}  {name[:80]}")
    print(f"{prefix}host syncs (item/bool/int of a device tensor): "
          f"{p.syncs / n:g} per {unit}")
    for name, us in sorted(p.kernels.items(), key=lambda kv: -kv[1])[:top]:
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
    p = read_profile(prof, TRAIN_STAGES)
    total = sum(p.kernels.values())
    print(f"{prefix}one more step under torch.profiler: wall {wall_s:.4f}s, "
          f"kernels {total / 1e3:.1f} ms, device busy "
          f"{total / (wall_s * 1e6):.3f}; backward kernels (autograd engine) "
          f"{p.ranges.get(ENGINE, (0.0, 0.0))[0] / 1e3:.1f} ms")
    _summary(p, stages_of(det, TRAIN_STAGES), 1, "step", prefix, top=8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--dcn-window", type=int, default=None,
                    help="clamp the semantic head's DCN offsets to +-R and "
                         "run its windowed kernel (default: exact DCN)")
    ap.add_argument("--detector", default="PanopticFuseTrack",
                    choices=PANOPTIC_DETECTORS)
    ap.add_argument("--preset", default="half-flow", choices=zoo.PRESETS)
    ap.add_argument("--size", default="1024x2048", help="HxW")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return profile_frames(args.frames, args.dcn_window, args.detector,
                          args.preset, args.size, args.device)


def profile_frames(frames=3, dcn_window=None, detector="PanopticFuseTrack",
                   preset="half-flow", size="1024x2048", device="cuda"):
    """``main``'s run; returns the frame's ms without the profiler, the
    device-busy share and the ``Profile``."""
    numerics = f32_policy()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("vps_torch.profile: no NVIDIA GPU; --device cpu "
                         "gives host times only")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    h, w = (int(v) for v in size.split("x"))

    cfg = zoo.preset_overrides(zoo.fusetrack_model_cfg(), preset)
    cfg["type"] = detector
    if detector == "PanopticFuse":
        cfg["track_head"] = None
    elif detector == "PanopticTrack":
        cfg["extra_neck"] = None
    cfg["panoptic"]["dcn_window"] = dcn_window
    det = random_init_(build_detector(cfg, test_cfg=zoo.fusetrack_test_cfg(),
                                      device=device), seed=0)
    rng = np.random.RandomState(0)
    n = 2 + 2 * frames
    clip = torch.from_numpy(rng.randn(n, 1, h, w, 3).astype(np.float32)).to(
        device)

    def run(lo, hi, carry):
        out, carry = predict_video(det, clip[lo:hi], [False] * (hi - lo),
                                   carry[0], carry[2], prev_feats=carry[1])
        if on_card:
            torch.cuda.synchronize()
        return carry

    _, carry = predict_video(det, clip[:1], [True],
                             empty_track_state(256, device=device), clip[0])
    carry = run(1, 2, carry)  # warm-up: first reset + one steady frame
    t0 = time.perf_counter()
    carry = run(2, 2 + frames, carry)
    plain_s = (time.perf_counter() - t0) / frames

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        carry = run(2 + frames, n, carry)
        wall_s = time.perf_counter() - t0
    p = read_profile(prof, STAGES)
    busy = sum(p.kernels.values()) / (wall_s * 1e6)
    print(f"frame ({detector}, {preset}, dcn_window={dcn_window}): "
          f"{plain_s * 1e3:.1f} ms "
          f"without the profiler, {wall_s / frames * 1e3:.1f} ms with it; "
          f"device busy {busy:.3f} of the profiled window ({frames} "
          f"frames, {h}x{w}, {device}); {describe(numerics)}")
    _summary(p, stages_of(det), frames, "frame")
    return plain_s * 1e3, busy, p


if __name__ == "__main__":
    main()
