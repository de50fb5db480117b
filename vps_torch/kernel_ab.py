"""Time the port's kernels against an earlier version of the port, on one card.

    git archive <commit> | tar -x -C _archive/parent    # a git-ignored path
    python3 -m vps_torch.kernel_ab --parent _archive/parent

Each version runs in a process of its own that imports ``vps_torch`` from its
tree, so it builds and launches that tree's kernels through that tree's
wrappers: any earlier version whose public ``correlation`` and
``deform_conv2d_windowed`` take the same arguments can be compared, whatever
its kernels' C interface. The processes run in the order earlier, current,
current, earlier, on the same seeded inputs at the main path's shapes
(1024x2048 frames, bf16 as at ``half-flow``; the f32 correlation at both
call sites of a train step and of the ``exact`` preset; the correlation
backward, ``correlation_backward``, at a train step's LiteFlowNetCorr shape in
f32 and bf16 and at FlowNetC's geometry in f32). Each holds every result to
the plain version first, then times the public function (CUDA-event
medians, host time included). Prints one line per shape with all four
times, the windowed DCN's sum over a frame's 12 launches, then the card as
``nvidia-smi`` names it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

H, W = 1024, 2048
CORR_SITES = {  # name: (shape, md, stride2, dtype)
    "liteflow": ((1, H // 4, W // 4, 256), 4, 1, "bfloat16"),
    "flownetc": ((1, H // 16, W // 16, 256), 20, 2, "bfloat16"),
    # float32: both call sites of a train step (the 800x1600 crop) and of
    # the exact preset (FlowNetC at flow_input_scale 1.0)
    "train liteflow": ((1, 200, 400, 256), 4, 1, "float32"),
    "train flownetc": ((1, 56, 104, 256), 20, 2, "float32"),
    "exact liteflow": ((1, H // 4, W // 4, 256), 4, 1, "float32"),
    "exact flownetc": ((1, H // 8, W // 8, 256), 20, 2, "float32"),
}
BACKWARD_SITES = {  # name: (shape, md, stride2, dtype)
    "train liteflow": ((1, 200, 400, 256), 4, 1, "float32"),
    "train liteflow bf16": ((1, 200, 400, 256), 4, 1, "bfloat16"),
    "flownetc": ((1, H // 16, W // 16, 256), 20, 2, "float32"),
}
DCN_LEVELS = [(H // 4 >> i, W // 4 >> i) for i in range(4)]
DCN_CONVS = [(256, 256), (256, 128), (128, 128)]
DCN_PREFIX = "deform_conv_windowed"


def measure(seed: int) -> dict:
    """Times of the importable ``vps_torch``'s kernels, by case name."""
    import torch

    from vps_torch.ops import (correlation, correlation_backward,
                               correlation_backward_reference, correlation_reference)
    from vps_torch.ops.deform_conv import (deform_conv2d_windowed,
                                           deform_conv2d_windowed_reference)

    def cuda_ms(fn, iters=25, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    times = {}
    for name, (shape, md, s2, dt) in CORR_SITES.items():
        f1 = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        f2 = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        want = correlation_reference(f1, f2, md, s2).float()
        got = correlation(f1, f2, md, s2).float()
        # chip_smoke.py's tolerances: bf16 one output ulp, f32 the sum's order
        atol, rtol = (1e-6, 2.0 ** -7) if dt == "bfloat16" else (1e-5, 1e-5)
        if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"correlation {name} disagrees with the plain version")
        times[f"correlation {name} {shape} md={md} s2={s2} {dt}"] = cuda_ms(
            lambda: correlation(f1, f2, md, s2))
        del f1, f2, want, got
    for name, (shape, md, s2, dt) in BACKWARD_SITES.items():
        d = 2 * (md // s2) + 1
        f1, f2, g = (torch.randn(sh, generator=gen, device="cuda").to(getattr(torch, dt))
                     for sh in (shape, shape, shape[:3] + (d * d,)))
        # chip_smoke.py's tolerances, relative to the largest gradient
        rel = 2.0 ** -7 if dt == "bfloat16" else 1e-5
        for got, want in zip(correlation_backward(g, f1, f2, md, s2),
                             correlation_backward_reference(g, f1, f2, md, s2)):
            if float((got.float() - want.float()).abs().max()) > rel * float(
                    want.float().abs().max()):
                raise AssertionError(f"correlation_backward {name} disagrees with the "
                                     "plain version")
        times[f"correlation_backward {name} {shape} md={md} s2={s2} {dt}"] = cuda_ms(
            lambda: correlation_backward(g, f1, f2, md, s2))
        del f1, f2, g
    for cin, cout in DCN_CONVS:
        for h, w in DCN_LEVELS:
            x = torch.randn((1, h, w, cin), generator=gen, device="cuda").bfloat16()
            off = torch.randn((1, h, w, 18), generator=gen, device="cuda") * 1.5
            weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
                      / (9 * cin) ** 0.5).bfloat16()
            want = deform_conv2d_windowed_reference(x, off, weight, 1, 4)
            err = float((deform_conv2d_windowed(x, off, weight, 1, 4) - want).abs().max())
            # the widest card tolerance the windowed DCN has been held to
            if err > 2.0 ** -6 * float(want.abs().max()):
                raise AssertionError(f"windowed DCN {h}x{w} {cin}->{cout} disagrees")
            times[f"{DCN_PREFIX} (1,{h},{w},{cin})->{cout} R=4 bf16"] = cuda_ms(
                lambda: deform_conv2d_windowed(x, off, weight, 1, 4))
            del x, off, want
    return times


def _f32_policy() -> str:
    """Apply this tree's numerics policy, loaded from its file (a measuring
    process imports ``vps_torch`` from the tree it measures, which may
    predate the policy: both trees are measured under this one); returns
    the settings as a line of text."""
    path = Path(__file__).resolve().parent / "utils" / "numerics.py"
    spec = importlib.util.spec_from_file_location("_vps_torch_numerics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.describe(mod.f32_policy())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="tree of the earlier version (holds vps_torch/)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # a tree: time it, print JSON
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    numerics = _f32_policy()
    if args.measure:
        sys.path[0] = str(Path(args.measure).resolve())  # not this file's directory
        print(json.dumps(measure(args.seed)))
        return
    if not args.parent:
        ap.error("--parent is required")
    current = Path(__file__).resolve().parents[1]
    runs = {"parent": [], "current": []}
    for name, tree in (("parent", args.parent), ("current", current),
                       ("current", current), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure", str(tree),
             "--seed", str(args.seed)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: the {name} run failed:\n{proc.stderr[-4000:]}")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    frame = [0.0, 0.0]
    for case in runs["current"][0]:
        old = [r[case] for r in runs["parent"]]
        new = [r[case] for r in runs["current"]]
        print(f"ab {case}: parent {old[0]:.4f} {old[1]:.4f} ms, current {new[0]:.4f} "
              f"{new[1]:.4f} ms, ratio {statistics.mean(old) / statistics.mean(new):.2f}x")
        if case.startswith(DCN_PREFIX):
            frame[0] += statistics.mean(old)
            frame[1] += statistics.mean(new)
    print(f"ab {DCN_PREFIX} per frame (12 launches): parent {frame[0]:.4f} ms, "
          f"current {frame[1]:.4f} ms, ratio {frame[0] / frame[1]:.2f}x")
    print(numerics)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
