"""Image corruptions for robustness benchmarking (the port's copy of the
JAX package's ``data/corruptions.py``): the corruption families of mmdet's
``tools/test_robustness.py`` (Hendrycks & Dietterich, "Benchmarking Neural
Network Robustness to Common Corruptions and Perturbations", ICLR 2019),
written in numpy with severity levels 1-5 from the published constants.

Host numpy passes over one HWC frame, as in the JAX package: ``corrupt``
seeds a ``np.random.RandomState``, so the same seed draws the same noise
and the outputs are the same. All functions take and return float32 HWC
images in [0, 255].
"""

from __future__ import annotations

import numpy as np


def _clip(x):
    return np.clip(x, 0, 255).astype(np.float32)


def gaussian_noise(img, severity=1, rng=None):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    rng = rng or np.random
    x = img / 255.0
    return _clip((x + rng.normal(size=x.shape, scale=c)) * 255.0)


def shot_noise(img, severity=1, rng=None):
    c = [60, 25, 12, 5, 3][severity - 1]
    rng = rng or np.random
    x = img / 255.0
    return _clip(rng.poisson(x * c) / float(c) * 255.0)


def impulse_noise(img, severity=1, rng=None):
    """Salt & pepper."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    rng = rng or np.random
    x = img.copy()
    m = rng.uniform(size=x.shape[:2])
    x[m < c / 2] = 0.0
    x[m > 1 - c / 2] = 255.0
    return _clip(x)


def _box_blur(img, k):
    """Separable box blur via cumsum (O(HW) regardless of k)."""
    if k <= 1:
        return img
    pad = k // 2
    x = np.pad(img, ((pad, k - 1 - pad), (pad, k - 1 - pad), (0, 0)),
               mode="edge")

    def _run(a, axis):
        c = np.cumsum(a, axis=axis, dtype=np.float64)
        zero = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([zero, c], axis=axis)
        hi = np.take(c, range(k, c.shape[axis]), axis=axis)
        lo = np.take(c, range(0, c.shape[axis] - k), axis=axis)
        return (hi - lo) / k

    x = _run(x, 0)
    x = _run(x, 1)
    assert x.shape[:2] == img.shape[:2], (x.shape, img.shape, k)
    return x


def defocus_blur(img, severity=1, rng=None):
    k = [3, 5, 7, 9, 13][severity - 1]
    # triple box blur ≈ gaussian/disk kernel
    x = img
    for _ in range(3):
        x = _box_blur(x, k)
    return _clip(x)


def motion_blur(img, severity=1, rng=None):
    k = [5, 9, 13, 17, 21][severity - 1]
    # horizontal streak via 1-D box filter
    pad = k // 2
    x = np.pad(img, ((0, 0), (pad, k - 1 - pad), (0, 0)), mode="edge")
    c = np.cumsum(x, axis=1, dtype=np.float64)
    c = np.concatenate([np.zeros_like(c[:, :1]), c], axis=1)
    x = (c[:, k:] - c[:, :-k]) / k
    return _clip(x)


def zoom_blur(img, severity=1, rng=None):
    zooms = {
        1: np.arange(1, 1.11, 0.01),
        2: np.arange(1, 1.16, 0.01),
        3: np.arange(1, 1.21, 0.02),
        4: np.arange(1, 1.26, 0.02),
        5: np.arange(1, 1.31, 0.03),
    }[severity]
    h, w, _ = img.shape
    out = np.zeros_like(img, np.float64)
    for z in zooms:
        ch, cw = int(h / z), int(w / z)
        top, left = (h - ch) // 2, (w - cw) // 2
        crop = img[top : top + ch, left : left + cw]
        yi = np.clip((np.arange(h) * ch / h).astype(int), 0, ch - 1)
        xi = np.clip((np.arange(w) * cw / w).astype(int), 0, cw - 1)
        out += crop[yi][:, xi]
    return _clip(out / len(zooms))


def brightness(img, severity=1, rng=None):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return _clip(img + c * 255.0)


def contrast(img, severity=1, rng=None):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    mean = img.mean(axis=(0, 1), keepdims=True)
    return _clip((img - mean) * c + mean)


def fog(img, severity=1, rng=None):
    """Plasma-fractal fog."""
    c, wib = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)][
        severity - 1
    ]
    rng = rng or np.random
    h, w, _ = img.shape
    size = 1 << int(np.ceil(np.log2(max(h, w))))
    fractal = _plasma(size, wibble=wib, rng=rng)[:h, :w]
    x = img / 255.0
    max_val = x.max()
    x = x + c * fractal[..., None]
    return _clip(x * max_val / (max_val + c) * 255.0)


def _plasma(size, wibble, rng):
    arr = np.zeros((size + 1, size + 1))
    step = size
    scale = wibble
    arr[0, 0] = arr[0, -1] = arr[-1, 0] = arr[-1, -1] = rng.uniform()
    while step > 1:
        half = step // 2
        # diamond
        arr[half::step, half::step] = (
            arr[:-1:step, :-1:step]
            + arr[step::step, :-1:step]
            + arr[:-1:step, step::step]
            + arr[step::step, step::step]
        ) / 4.0 + scale * rng.uniform(-1, 1, arr[half::step, half::step].shape)
        # square (approximate: average of vertical/horizontal neighbors)
        arr[half::step, ::step] = (
            arr[:-1:step, ::step] + arr[step::step, ::step]
        ) / 2.0 + scale * rng.uniform(-1, 1, arr[half::step, ::step].shape)
        arr[::step, half::step] = (
            arr[::step, :-1:step] + arr[::step, step::step]
        ) / 2.0 + scale * rng.uniform(-1, 1, arr[::step, half::step].shape)
        step = half
        scale /= 2.0
    arr -= arr.min()
    return arr / max(arr.max(), 1e-8)


def snow(img, severity=1, rng=None):
    c = [0.1, 0.2, 0.3, 0.45, 0.55][severity - 1]
    rng = rng or np.random
    h, w, _ = img.shape
    layer = rng.normal(size=(h, w), loc=0.05, scale=0.3)
    layer = np.where(layer > 1.0 - c, 1.0, 0.0)
    layer = _box_blur(layer[..., None].repeat(3, -1), 3)[..., :1]
    x = img / 255.0
    gray = x.mean(axis=-1, keepdims=True)
    x = np.maximum(x, gray * 1.5 + 0.5 * layer) * (1 - layer * 0.4) + layer
    return _clip(x * 255.0)


def frost(img, severity=1, rng=None):
    """Approximated with high-frequency plasma overlay (no frost textures
    shipped)."""
    c = [(1.0, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)][
        severity - 1
    ]
    rng = rng or np.random
    h, w, _ = img.shape
    size = 1 << int(np.ceil(np.log2(max(h, w))))
    tex = _plasma(size, wibble=2.5, rng=rng)[:h, :w]
    return _clip(img * c[0] + tex[..., None] * 255.0 * c[1])


def elastic_transform(img, severity=1, rng=None):
    c = [6, 5, 4, 3, 2][severity - 1]
    rng = rng or np.random
    h, w, _ = img.shape
    dx = _box_blur(rng.uniform(-1, 1, (h, w, 1)), 33)[..., 0] * c * 4
    dy = _box_blur(rng.uniform(-1, 1, (h, w, 1)), 33)[..., 0] * c * 4
    yy = np.clip(np.arange(h)[:, None] + dy, 0, h - 1).astype(int)
    xx = np.clip(np.arange(w)[None, :] + dx, 0, w - 1).astype(int)
    return _clip(img[yy, xx])


def pixelate(img, severity=1, rng=None):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w, _ = img.shape
    ch, cw = max(int(h * c), 1), max(int(w * c), 1)
    yi = (np.arange(ch) * h / ch).astype(int)
    xi = (np.arange(cw) * w / cw).astype(int)
    small = img[yi][:, xi]
    yi2 = (np.arange(h) * ch / h).astype(int)
    xi2 = (np.arange(w) * cw / w).astype(int)
    return _clip(small[yi2][:, xi2])


def jpeg_compression(img, severity=1, rng=None):
    import io

    from PIL import Image

    c = [25, 18, 15, 10, 7][severity - 1]
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=c)
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32)


def gaussian_blur(img, severity=1, rng=None):
    k = [3, 5, 7, 9, 11][severity - 1]
    x = img
    for _ in range(3):
        x = _box_blur(x, k)
    return _clip(x)


def saturate(img, severity=1, rng=None):
    c = [(0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2)][severity - 1]
    x = img / 255.0
    gray = x.mean(axis=-1, keepdims=True)
    x = np.clip(gray + (x - gray) * c[0] + c[1], 0, 1)
    return _clip(x * 255.0)


def spatter(img, severity=1, rng=None):
    c = [0.62, 0.65, 0.68, 0.7, 0.75][severity - 1]
    rng = rng or np.random
    h, w, _ = img.shape
    liquid = rng.normal(size=(h, w), loc=0.65, scale=0.3)
    liquid = _box_blur(liquid[..., None].repeat(3, -1), 5)[..., 0]
    m = (liquid > c)[..., None].astype(np.float32)
    water = np.asarray([238.0, 238.0, 175.0])  # light splash color (BGRish)
    return _clip(img * (1 - 0.6 * m) + water * 0.6 * m)


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "gaussian_blur": gaussian_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "saturate": saturate,
    "spatter": spatter,
}

BENCHMARK_CORRUPTIONS = [  # the 15-corruption ICLR'19 benchmark set
    "gaussian_noise", "shot_noise", "impulse_noise",
    "defocus_blur", "gaussian_blur", "motion_blur", "zoom_blur",
    "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression",
]


def corrupt(img, corruption: str, severity: int = 1, seed: int | None = None):
    """Apply a named corruption at severity 1-5 to a HWC [0,255] image."""
    if corruption not in CORRUPTIONS:
        raise KeyError(f"unknown corruption {corruption!r}")
    if not 1 <= severity <= 5:
        raise ValueError(f"severity {severity} is not in 1..5")
    rng = np.random.RandomState(seed) if seed is not None else None
    return CORRUPTIONS[corruption](
        np.asarray(img, np.float32), severity, rng=rng
    )
