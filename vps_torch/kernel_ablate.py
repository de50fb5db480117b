"""Timing ablations of the f32 correlation kernel on one card: what holds it
above its bound.

    python3 -m vps_torch.kernel_ablate

Builds ``vps_torch/csrc/correlation.cu`` as it is and in copies with one
step of ``simt::corr_f32`` switched off by a text change, each by nvcc into a
temporary directory, and times each build's C entry point at the f32
correlation's main-path shapes (both call sites of a train step and of the
``exact`` preset), CUDA-event medians. A copy's results are wrong on
purpose; only its time counts:

  no-staging  the ring's cp.async copies are not issued: the product, the
              barriers and the epilogue run on whatever the ring holds;
  no-product  the FMAs are skipped: the staging, the barriers and the
              epilogue remain.

The build as it is is held to ``correlation_reference`` first. Prints each
build's registers and spills (``ptxas -v``), one line per build with its
times, and the card as ``nvidia-smi`` names it.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ABLATIONS = {  # name: (text in the source, its replacement)
    "as is": None,
    "no-staging": ("    if (u < U) {\n      const int pass = u / nck, q = tid & 7,",
                   "    if (u < 0) {\n      const int pass = u / nck, q = tid & 7,"),
    "no-product": ("if (live && i <= D && yy >= 0 && yy < H) {",
                   "if (live && i <= D && yy >= 0 && yy < H && C < 0) {"),
}


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
    info, take = [], False
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            take = "corr_f32" in line
        elif take and ("spill" in line or "Used" in line):
            info.append(line.split(":", 1)[-1].strip())
    return name, lib, info


def main(argv=None):
    import torch

    from vps_torch.kernel_ab import CORR_SITES
    from vps_torch.ops import cuda_build
    from vps_torch.ops.correlation import correlation_reference
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

        for name, lib, info in builds:
            fn = ctypes.CDLL(str(lib)).vps_correlation_forward
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            row = []
            for site, shape, md, s2, f1, f2, out in data:
                def call():
                    rc = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), *shape, md, s2, 0,
                            stream)
                    if rc:
                        raise SystemExit(f"kernel_ablate: {name} {site}: launch error {rc}")
                call()
                torch.cuda.synchronize()
                if ABLATIONS[name] is None:
                    want = correlation_reference(f1, f2, md, s2)
                    if not bool(((out - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()):
                        raise SystemExit(f"kernel_ablate: {site} disagrees with the plain "
                                         "version")
                row.append(f"{site} {cuda_ms(call):.4f} ms")
            print(f"ablate {name}: " + ", ".join(row) + " | ptxas: " + "; ".join(info))
    print(describe(numerics))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    sys.exit(main())
