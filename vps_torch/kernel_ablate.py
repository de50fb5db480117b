"""Timing ablations of the f32 correlation kernels on one card: what holds
each above its bound.

    python3 -m vps_torch.kernel_ablate

Builds ``vps_torch/csrc/correlation.cu`` as it is and in copies with one
step of a kernel switched off by a text change, each by nvcc into a
temporary directory, and times each build's C entry points, CUDA-event
medians: the forward (``simt::corr_f32``) at the f32 correlation's main-path
shapes (both call sites of a train step and of the ``exact`` preset), the
backward (``bwd::corr_backward``) at a train step's shape. A copy's results
are wrong on purpose; only its time counts:

  no-staging      forward: the ring's cp.async copies are not issued: the
                  product, the barriers and the epilogue run on whatever the
                  ring holds;
  no-product      forward: the FMAs are skipped: the staging, the barriers
                  and the epilogue remain;
  bwd no-staging  backward: no feature row or weight is staged;
  bwd no-product  backward: no warp runs its band product.

The build as it is is held to the plain versions first. Prints each build's
registers and spills (``ptxas -v``), one line per build with its times, and
the card as ``nvidia-smi`` names it.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ABLATIONS = {  # name: (text in the source, its replacement); "bwd ...": the backward
    "as is": None,
    "no-staging": ("    if (u < U) {\n      const int pass = u / nck, q = tid & 7,",
                   "    if (u < 0) {\n      const int pass = u / nck, q = tid & 7,"),
    "no-product": ("if (live && i <= D && yy >= 0 && yy < H) {",
                   "if (live && i <= D && yy >= 0 && yy < H && C < 0) {"),
    "bwd no-staging": ("    if (t < U && fy >= 0 && fy < H) {",
                       "    if (t < 0 && fy >= 0 && fy < H) {"),
    "bwd no-product": ("    if ((a0 || a1) && fy >= 0 && fy < H) {  // warp-uniform",
                       "    if ((a0 || a1) && fy >= 0 && fy < H && C < 0) {  // warp-uniform"),
}
BACKWARD_SITE = ("train liteflow", (1, 200, 400, 256), 4, 1)
# the f32 instances at the ablated shapes, by a piece of their mangled names:
# corr_f32<G, NH>, corr_backward<float, 8>
KERNELS = {"corr_f32": "corr_f32", "corr_backwardIfLi8": "corr_backward"}


def _build(name, source, out_dir):
    """Compile one variant of the source; returns (name, library, ptxas lines)."""
    from vps_torch.ops import cuda_build

    text = source
    if ABLATIONS[name] is not None:
        old, new = ABLATIONS[name]
        if old not in text:
            raise SystemExit(f"kernel_ablate: {name}: its text is not in the source")
        text = text.replace(old, new)
    stem = name.replace(" ", "_")
    src = Path(out_dir) / f"{stem}.cu"
    src.write_text(text)
    lib = Path(out_dir) / f"{stem}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_ablate: nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    info, take = [], None
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            take = next((k for k in KERNELS if k in line), None)
        elif take and ("spill" in line or "Used" in line):
            info.append(f"{KERNELS[take]}: {line.split(':', 1)[-1].strip()}")
    return name, lib, info


def main(argv=None):
    import torch

    from vps_torch.kernel_ab import CORR_SITES
    from vps_torch.ops import cuda_build
    from vps_torch.ops.correlation import (correlation_backward_reference,
                                           correlation_reference)
    from vps_torch.utils.numerics import describe, f32_policy

    numerics = f32_policy()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablate: needs an NVIDIA GPU")
    sites = {k: v for k, v in CORR_SITES.items() if v[3] == "float32"}
    source = (cuda_build.CSRC / "correlation.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(ABLATIONS)) as pool:  # one nvcc per build
            builds = list(pool.map(lambda n: _build(n, source, tmp), ABLATIONS))
        gen = torch.Generator(device="cuda").manual_seed(0)
        data = []
        for name, (shape, md, s2, _) in sites.items():
            f1 = torch.randn(shape, generator=gen, device="cuda")
            f2 = torch.randn(shape, generator=gen, device="cuda")
            d = 2 * (md // s2) + 1
            out = torch.empty(shape[:3] + (d * d,), device="cuda")
            data.append((name, shape, md, s2, f1, f2, out))
        site, shape, md, s2 = BACKWARD_SITE
        d = 2 * (md // s2) + 1
        bwd = [torch.randn(shape[:3] + (d * d,), generator=gen, device="cuda")]
        bwd += [torch.randn(shape, generator=gen, device="cuda") for _ in range(2)]
        bwd += [torch.empty(shape, device="cuda") for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream

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

        def timed(name, what, launch):
            def call():
                rc = launch()
                if rc:
                    raise SystemExit(f"kernel_ablate: {name} {what}: launch error {rc}")
            call()
            torch.cuda.synchronize()
            return call

        for name, lib, info in builds:
            so = ctypes.CDLL(str(lib))
            fwd_fn = so.vps_correlation_forward
            fwd_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fwd_fn.restype = ctypes.c_int
            bwd_fn = so.vps_correlation_backward
            bwd_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            bwd_fn.restype = ctypes.c_int
            row = []
            if not name.startswith("bwd "):
                for fsite, fshape, fmd, fs2, f1, f2, out in data:
                    call = timed(name, fsite, lambda: fwd_fn(
                        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), *fshape, fmd, fs2, 0,
                        stream))
                    if ABLATIONS[name] is None:
                        want = correlation_reference(f1, f2, fmd, fs2)
                        if not bool(((out - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()):
                            raise SystemExit(f"kernel_ablate: {fsite} disagrees with the "
                                             "plain version")
                    row.append(f"{fsite} {cuda_ms(call):.4f} ms")
            if ABLATIONS[name] is None or name.startswith("bwd "):
                g, f1, f2, gf1, gf2 = bwd
                call = timed(name, site, lambda: bwd_fn(
                    g.data_ptr(), f1.data_ptr(), f2.data_ptr(), gf1.data_ptr(),
                    gf2.data_ptr(), *shape, md, s2, 0, stream))
                if ABLATIONS[name] is None:
                    # chip_smoke.py's tolerance: 1e-5 of the largest gradient
                    for got, want in zip((gf1, gf2),
                                         correlation_backward_reference(g, f1, f2, md, s2)):
                        if float((got - want).abs().max()) > 1e-5 * float(want.abs().max()):
                            raise SystemExit(f"kernel_ablate: backward {site} disagrees "
                                             "with the plain version")
                row.append(f"backward {site} {cuda_ms(call):.4f} ms")
            print(f"ablate {name}: " + ", ".join(row) + " | ptxas: " + "; ".join(info))
    print(describe(numerics))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    sys.exit(main())
