"""The port's native host library (its own copy of the JAX package's
``native``): COCO's compressed RLE codec, the legacy "+1" IoU matrix, and
greedy NMS and Soft-NMS on the host, in C++ (``rle.cpp``, ``nms.cpp``)
through ctypes, with the plain numpy versions beside them (``*_np``, what
the tests hold the library to).

The library is built with ``g++ -O3 -shared -fPIC`` at its first use, into
the git-ignored ``vps_torch/_build/``, named by a hash of its sources and
flags (as ``ops/cuda_build.py`` names the kernels' builds); nothing is
built when the module is imported. A failed build or load raises: no call
falls back to numpy behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
SOURCES = ("rle.cpp", "nms.cpp")
# no contraction into fused multiply-adds: the IoU's float32 arithmetic stays
# that of the numpy versions, bit for bit
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def build() -> Path:
    """Compile the library into ``_build/`` unless an identical build
    exists; returns its path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update((HERE / name).read_bytes())
    out = BUILD_DIR / f"vps_native-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"vps_torch.native: no C++ compiler {cxx!r} "
                           f"(set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(str(HERE / n) for n in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"vps_torch.native: {' '.join(cmd)} failed (rc "
                           f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; one handle per process."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.rle_decode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, _U8]
        lib.rle_encode.restype = ctypes.c_int
        lib.rle_encode.argtypes = [_U8, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
        lib.bbox_overlaps.restype = None
        lib.bbox_overlaps.argtypes = [_F32, ctypes.c_int, _F32, ctypes.c_int,
                                      _F32]
        lib.cpu_nms.restype = ctypes.c_int
        lib.cpu_nms.argtypes = [_F32, ctypes.c_int, ctypes.c_float, _I32]
        lib.cpu_soft_nms.restype = ctypes.c_int
        lib.cpu_soft_nms.argtypes = [_F32, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int, _I32]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# ---------------------------------------------------------------------------
# RLE codec
# ---------------------------------------------------------------------------


def runs_to_mask(cnts, h: int, w: int) -> np.ndarray:
    """Uncompressed RLE (run lengths, zeros first, column-major) to an
    (h, w) uint8 mask."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    v = 0
    for n in cnts:
        flat[pos:pos + int(n)] = v
        pos += int(n)
        v = 1 - v
    return flat.reshape(w, h).T  # column-major


def rle_decode_np(counts, h: int, w: int) -> np.ndarray:
    """The plain version of ``rle_decode``."""
    if isinstance(counts, (list, tuple)):
        return runs_to_mask(counts, h, w)
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    cnts = []
    p = 0
    while p < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return runs_to_mask(cnts, h, w)


def rle_encode_np(mask: np.ndarray) -> str:
    """The plain version of ``rle_encode``."""
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    # run lengths starting with zeros
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    cnts = np.diff(bounds).tolist()
    if flat[0] == 1:
        cnts = [0] + cnts
    out = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """A compressed RLE string (COCO's wire format), or an uncompressed
    counts list, to an (h, w) uint8 mask."""
    if isinstance(counts, (list, tuple)):  # uncompressed RLE
        return runs_to_mask(counts, h, w)
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    out = np.zeros(h * w, np.uint8)  # column-major buffer
    rc = load().rle_decode(counts, h, w, _ptr(out, _U8))
    if rc != 0:
        raise ValueError(f"rle_decode: the runs overrun a {h}x{w} mask")
    return out.reshape(w, h).T


def rle_encode(mask: np.ndarray) -> str:
    """An (h, w) {0, 1} mask to its compressed RLE string."""
    h, w = mask.shape
    fmask = np.ascontiguousarray(
        np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1))
    cap = 4 * h * w + 16
    buf = ctypes.create_string_buffer(cap)
    n = load().rle_encode(_ptr(fmask, _U8), h, w, buf, cap)
    if n < 0:
        raise RuntimeError(f"rle_encode: {cap} bytes did not hold the string")
    return buf.value.decode("ascii")


# ---------------------------------------------------------------------------
# IoU and NMS (legacy +1 IoU: a box from x1 to x2 covers x2 - x1 + 1 pixels)
# ---------------------------------------------------------------------------


def bbox_overlaps_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The plain version of ``bbox_overlaps``: the same float32 operations
    in the same order."""
    a = np.ascontiguousarray(a[:, :4], np.float32)
    b = np.ascontiguousarray(b[:, :4], np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    ab = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return (inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)).astype(
        np.float32)


def bbox_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The (len(a), len(b)) float32 IoU matrix of two box arrays (their
    first 4 columns)."""
    a = np.ascontiguousarray(a[:, :4], np.float32)
    b = np.ascontiguousarray(b[:, :4], np.float32)
    out = np.zeros((a.shape[0], b.shape[0]), np.float32)
    if out.size:
        load().bbox_overlaps(_ptr(a, _F32), a.shape[0], _ptr(b, _F32),
                             b.shape[0], _ptr(out, _F32))
    return out


def cpu_nms_np(dets: np.ndarray, thresh: float) -> np.ndarray:
    """The plain version of ``cpu_nms``."""
    dets = np.ascontiguousarray(dets, np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    keep = []
    suppressed = np.zeros(len(dets), bool)
    ious = bbox_overlaps_np(dets[:, :4], dets[:, :4])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= ious[i] > thresh
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def cpu_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy hard NMS of (N, 5) dets (x1, y1, x2, y2, score): the kept
    indices in descending score order (ties in index order)."""
    dets = np.ascontiguousarray(dets, np.float32)
    n = dets.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    keep = np.zeros((n,), np.int32)
    k = load().cpu_nms(_ptr(dets, _F32), n, ctypes.c_float(thresh),
                       _ptr(keep, _I32))
    return keep[:k].astype(np.int64)


_SOFT_METHODS = {"hard": 0, "linear": 1, "gaussian": 2}


def cpu_soft_nms_np(dets: np.ndarray, iou_thr: float = 0.3,
                    sigma: float = 0.5, min_score: float = 1e-3,
                    method: str = "linear") -> tuple:
    """The plain version of ``cpu_soft_nms``: the same greedy loop."""
    work = np.ascontiguousarray(dets, np.float32).copy()
    n = work.shape[0]
    if method not in _SOFT_METHODS:
        raise ValueError(f"soft-NMS method {method!r}")
    done = np.zeros(n, bool)
    keep = []
    while True:
        cand = np.where(~done & (work[:, 4] > min_score))[0]
        if cand.size == 0:
            break
        best = cand[np.argmax(work[cand, 4])]
        done[best] = True
        keep.append(best)
        ov = bbox_overlaps_np(work[best:best + 1, :4], work[:, :4])[0]
        if method == "linear":
            w = np.where(ov > iou_thr, 1.0 - ov, 1.0)
        elif method == "gaussian":
            w = np.exp(-(ov ** 2) / sigma)
        else:
            w = np.where(ov > iou_thr, 0.0, 1.0)
        w[done] = 1.0
        work[:, 4] *= w
    keep = np.asarray(keep, np.int64)
    return work[keep], keep


def cpu_soft_nms(dets: np.ndarray, iou_thr: float = 0.3, sigma: float = 0.5,
                 min_score: float = 1e-3, method: str = "linear") -> tuple:
    """Soft-NMS on the host (the reference's soft_nms_cpu.pyx): take the
    highest score above ``min_score``, decay the others' scores by their
    IoU with it (``hard``: to 0 above ``iou_thr``; ``linear``: x (1 - IoU)
    above it; ``gaussian``: x exp(-IoU^2 / sigma)), repeat. Returns (the
    rescored dets of the kept boxes (K, 5), their indices (K,)), in the
    order taken."""
    dets = np.ascontiguousarray(dets, np.float32).copy()
    n = dets.shape[0]
    if n == 0:
        return dets, np.zeros((0,), np.int64)
    keep = np.zeros((n,), np.int32)
    k = load().cpu_soft_nms(
        _ptr(dets, _F32), n, ctypes.c_float(iou_thr), ctypes.c_float(sigma),
        ctypes.c_float(min_score), _SOFT_METHODS[method], _ptr(keep, _I32))
    kept = keep[:k].astype(np.int64)
    return dets[kept], kept
