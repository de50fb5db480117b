"""Optical-flow utilities (the port's copy of the JAX package's
``utils/flow.py``, mmdet's ``flow_utils``): image denormalisation for the
FlowNet input, Middlebury .flo file IO, and flow -> RGB colour coding.
"""

from __future__ import annotations

import numpy as np
import torch

TAG_FLOAT = 202021.25  # the .flo magic number


def denormalize(img, mean, std):
    """Undo the dataset's normalisation so FlowNet sees raw intensities:
    img (B, H, W, 3) normalised, returns img * std + mean, in [0, 255]."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return img * std + mean


def read_flo(path) -> np.ndarray:
    """Read a Middlebury .flo file → (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        assert tag == TAG_FLOAT, f"bad .flo magic {tag} in {path}"
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())


def _color_wheel() -> np.ndarray:
    """The Middlebury colour wheel (55 colours), as mmdet's flow2img."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


def flow_to_rgb(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 Middlebury color coding."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u * u + v * v)

    wheel = _color_wheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # (-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.where(bad, 0, np.floor(255 * col)).astype(np.uint8)
    return img
