"""Training observability helpers (the port's copy of the JAX package's
``utils/metrics.py``, UPSNet's ``lib/utils``): Speedometer (samples/s
every ``frequent`` steps), EvalMetric (streaming means), Timer (an
accumulating stopwatch) and the detection ``colormap(n)``.

``colormap(n)`` here is the n-colour golden-ratio palette; the palette of
``vps_torch.utils.visualize.colormap(rgb)`` is another one, as in the JAX
package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class Timer:
    """Accumulating stopwatch (UPSNet's lib/utils/timer.py)."""

    def __init__(self):
        self.reset()

    def tic(self):
        self._start = time.time()

    def toc(self) -> float:
        dt = time.time() - self._start
        self.total_time += dt
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return dt

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.average_time = 0.0
        self._start = time.time()


class Speedometer:
    """samples/sec logger callback (UPSNet's lib/utils/callback.py): call
    once per step with the batch size; every `frequent` steps it reports and
    resets the window."""

    def __init__(self, frequent: int = 50, logger=None):
        self.frequent = frequent
        self.logger = logger
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.count = 0

    def __call__(self, batch_size: int = 1) -> Optional[float]:
        self.count += 1
        if not self.init:
            self.init = True
            self.tic = time.time()
            self.last_count = self.count
            return None
        if (self.count - self.last_count) % self.frequent == 0:
            speed = (
                self.frequent * batch_size / (time.time() - self.tic)
            )
            if self.logger is not None:
                self.logger.info("Speed: %.2f samples/sec", speed)
            self.tic = time.time()
            self.last_count = self.count
            return speed
        return None


class EvalMetric:
    """Streaming scalar metric accumulator (UPSNet's lib/utils/metric.py):
    update(name→value) sums; get() returns means since the last reset."""

    def __init__(self, name: str = "metric"):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst: Dict[str, int] = {}
        self.sum_metric: Dict[str, float] = {}

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.sum_metric[k] = self.sum_metric.get(k, 0.0) + float(v) * n
            self.num_inst[k] = self.num_inst.get(k, 0) + n

    def get(self) -> Dict[str, float]:
        return {
            k: self.sum_metric[k] / max(self.num_inst[k], 1)
            for k in self.sum_metric
        }


def colormap(n: int = 79, rgb: bool = True) -> np.ndarray:
    """Detectron-style color list (UPSNet's lib/utils/colormap.py): (N, 3)
    float in
    [0, 255], cycled from the published 79-color palette seed via golden-
    ratio hue stepping (re-derived, not copied)."""
    import colorsys

    colors = []
    h = 0.0
    for i in range(n):
        h = (h + 0.61803398875) % 1.0
        s = 0.65 + 0.2 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        colors.append(colorsys.hsv_to_rgb(h, min(s, 1.0), min(v, 1.0)))
    cmap = np.asarray(colors, np.float64) * 255.0
    if not rgb:
        cmap = cmap[:, ::-1]
    return cmap
