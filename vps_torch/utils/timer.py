"""Wall-clock accumulation timer (the port's copy of the JAX package's
``utils/timer.py``): UPSNet's ``lib/utils/timer.py`` surface (tic/toc with
a running average) with a context-manager form.

CUDA work is asynchronous: end the timed region with
``torch.cuda.synchronize()`` (or a copy of its last result to the host)
before toc(), or the timer measures the launches, not the work.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self.diff = 0.0
        self._start = None

    def tic(self):
        self._start = time.perf_counter()
        return self

    def toc(self, average: bool = True) -> float:
        if self._start is None:
            raise RuntimeError("toc() before tic()")
        self.diff = time.perf_counter() - self._start
        self.total += self.diff
        self.calls += 1
        return self.average if average else self.diff

    @property
    def average(self) -> float:
        return self.total / self.calls if self.calls else 0.0

    # context-manager flavor: `with t: ...` == tic/toc
    def __enter__(self):
        return self.tic()

    def __exit__(self, *exc):
        self.toc()
        return False
