"""The traced window, read from the profiler's kineto events.

The reading is a frozen copy of the port's ``read_profile`` arithmetic
(kineto events read without building torch's event tree, which takes a
minute for a step's ~700k events), widened to keep what the per-layer
readers need: the kernels' time by name and the union of their intervals,
every named range of the program on the host, and the host syncs. Device
busy time is the union, not the sum: two CUDA streams overlap.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

SYNC = "aten::_local_scalar_dense"
# the harness's own range around the window
WINDOW = "bench.window"


class Trace(NamedTuple):
    by_name: Dict[str, Tuple[int, int]]  # kernel name -> (device ns, count)
    busy: List[Tuple[int, int]]  # the union of kernel intervals, in window
    ranges: Dict[str, List[Tuple[int, int, int]]]  # name -> (tid, t0, t1)
    syncs: int  # item/bool/int of a device tensor
    window: Tuple[int, int]  # the traced window, ns


def make(kernels, ranges, syncs, window) -> Trace:
    """A Trace from kernel intervals (name, start ns, end ns): their time
    and count by name, and their union clipped to the window, merged."""
    by_name: Dict[str, Tuple[int, int]] = {}
    for name, t0, t1 in kernels:
        ns, n = by_name.get(name, (0, 0))
        by_name[name] = (ns + t1 - t0, n + 1)
    lo, hi = window
    merged: List[List[int]] = []
    for t0, t1 in sorted((max(t0, lo), min(t1, hi)) for _, t0, t1 in kernels):
        if t1 <= t0:
            continue
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return Trace(by_name, [(a, b) for a, b in merged], ranges, syncs, window)


def read(prof, stages) -> Trace:
    """The kernels (and copies) on the card, the named ranges ``stages``
    and the harness's WINDOW (host spans), and the host syncs of ``prof``;
    the window is WINDOW's span. A range's device-side copy (a user
    annotation: every ``record_function``, listed or not) is no operation
    on the card."""
    kernels, ranges, syncs = [], {}, 0
    stages = set(stages) | {WINDOW}
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type()
        if dev == cpu:
            name = e.name()
            if name in stages:
                t0 = e.start_ns()
                ranges.setdefault(name, []).append(
                    (e.start_thread_id(), t0, t0 + e.duration_ns()))
            elif name == SYNC:
                syncs += 1
        elif dev == cuda and not e.is_user_annotation():
            t0 = e.start_ns()
            kernels.append((e.name(), t0, t0 + e.duration_ns()))
    _, lo, hi = ranges[WINDOW][0]
    return make(kernels, ranges, syncs, (lo, hi))


def busy_seconds(tr: Trace) -> float:
    return sum(b - a for a, b in tr.busy) / 1e9


def window_seconds(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def device_ops(tr: Trace, top=10):
    """[[kernel name, seconds]] of the kernels with the most device time."""
    return [[n[:200], v[0] / 1e9] for n, v in
            sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:top]]


def idle_gaps(tr: Trace, top=10):
    """[[what the host was doing, seconds]]: the device's idle time inside
    the window, each gap put under the program ranges open on the host (on
    any thread) at its middle, summed by label, the largest ``top``. One
    sweep over the ranges' edges and the gaps, both in time order."""
    edges = sorted((t, d, name) for name, items in tr.ranges.items()
                   if name != WINDOW
                   for _, t0, t1 in items for t, d in ((t0, 1), (t1, -1)))
    lo, hi = tr.window
    bounds = [lo] + [t for iv in tr.busy for t in iv] + [hi]
    open_, by, i = {}, {}, 0
    label = None
    for a, b in zip(bounds[::2], bounds[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(edges) and edges[i][0] <= mid:
            _, d, name = edges[i]
            open_[name] = open_.get(name, 0) + d
            label, i = None, i + 1
        if label is None:
            label = ("+".join(sorted(n for n, c in open_.items() if c > 0))
                     or "host outside the program's ranges")
        by[label] = by.get(label, 0) + (b - a)
    return [[n, v / 1e9] for n, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def range_host_seconds(tr: Trace, name: str) -> float:
    """Summed host duration of the range ``name``."""
    return sum(t1 - t0 for _, t0, t1 in tr.ranges.get(name, ())) / 1e9


def kernel_seconds(tr: Trace, parts) -> Tuple[float, int]:
    """(device seconds, launches) of the kernels whose names hold a part."""
    sel = [v for n, v in tr.by_name.items() if any(p in n for p in parts)]
    return sum(ns for ns, _ in sel) / 1e9, sum(n for _, n in sel)
