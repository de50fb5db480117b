"""Build-at-first-use for the hand-written CUDA kernels in ``vps_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``. Libraries are cached under ``vps_torch/_build/`` keyed by a
hash of the source and flags; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# held by the kernel wrappers while they count a launch: run_video_streams
# launches from several threads at once
COUNT_LOCK = threading.Lock()
# seconds spent in nvcc per source, for reporting (0.0 when cached)
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's install default
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``_build/`` unless an identical build
    exists; returns the library path."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_seconds.setdefault(source, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[source] = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per process."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            lib.vps_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vps_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib


def on_device(device):
    """A context that makes the CUDA ``device`` current for a launch (a no-op
    when it already is, which saves the switch on every call)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_ptr(device) -> int:
    """The raw cudaStream_t of ``device``'s current stream, for a launch.
    Through ``torch._C`` (as Triton's launchers do): the public
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    and costs a few microseconds a launch."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.vps_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
