"""Train loader (the port's copy of the JAX package's ``data/loader.py``,
one host): a deterministic per-epoch permutation (seed = base_seed + epoch,
mmdet's DistSamplerSeedHook), each sample drawn with a ``RandomState`` of
its own seed, loaded and augmented in ``num_workers`` OS processes, and
yielded as batch dicts of numpy arrays with a leading dim of
``batch_size``. Every sample is the same shape (the static crop), so no
aspect-ratio grouping.

Workers are processes, as decoding, RLE and augmentation are numpy/cv2 work
that holds the GIL. They are spawned, not forked: a trainer has usually
made its CUDA context before the loader's first epoch, and a forked child
inherits it. Each worker gets the dataset once, at its start, receives
(seq, index, seed) tasks and returns (seq, sample); the parent reorders by
seq, so batches are identical to the serial path's (``num_workers=0``) for
the same seed. Prefetch depth is ``prefetch_batches`` full batches ahead of
the consumer.
"""

from __future__ import annotations

import multiprocessing
import queue
from typing import Dict, Iterator, Optional

import numpy as np


def _load_one(dataset, idx: int, seed: int, n: int, max_retries: int):
    r = np.random.RandomState(seed)
    for _ in range(max_retries):
        s = dataset.prepare_train(idx, r)
        if s is not None:
            return s
        idx = int(r.randint(n))
    raise RuntimeError("too many invalid samples in a row")


def _worker_loop(dataset, task_q, out_q, n, max_retries):
    while True:
        task = task_q.get()
        if task is None:
            return
        seq, idx, seed = task
        try:
            out_q.put((seq, _load_one(dataset, idx, seed, n, max_retries)))
        except Exception as e:  # surfaced in the parent
            out_q.put((seq, e))


class TrainLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        repeat_times: int = 1,
        num_workers: int = 2,
        max_retries: int = 20,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.repeat_times = getattr(dataset, "repeat_times", None) or repeat_times
        self.num_workers = num_workers
        self.max_retries = max_retries
        self.prefetch_batches = max(prefetch_batches, 2)
        self._procs = []
        self._task_q = None
        self._out_q = None

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) * self.repeat_times
        return n // self.batch_size

    # ------------------------------------------------------------------
    # worker pool lifecycle (lazy; survives across epochs)
    # ------------------------------------------------------------------

    def _ensure_pool(self):
        if self._procs:
            return
        ctx = multiprocessing.get_context("spawn")
        self._task_q = ctx.Queue()
        self._out_q = ctx.Queue()
        n = len(self.dataset)
        for _ in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, self._task_q, self._out_q, n,
                      self.max_retries),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def close(self):
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._procs = []
        self._task_q = None
        self._out_q = None

    def __del__(self):  # pragma: no cover
        try:
            if self._procs:
                for p in self._procs:
                    p.terminate()
        except Exception:
            pass

    def _next_result(self, poll: float = 5.0):
        """The next (seq, sample) from the workers; raises if a worker has
        died (a spawned worker that fails to start never answers)."""
        while True:
            try:
                return self._out_q.get(timeout=poll)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"loader workers exited with codes "
                                       f"{dead}") from None

    # ------------------------------------------------------------------

    def _plan_epoch(self, epoch: int):
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + epoch)
        order = np.concatenate(
            [rng.permutation(n) for _ in range(self.repeat_times)]
        )
        steps = len(order) // self.batch_size
        # the JAX loader's per-sample seeds, at host 0
        seeds = [(self.seed + epoch) * 100003 + i for i in range(len(order))]
        return order, seeds, steps, n

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order, seeds, steps, n = self._plan_epoch(epoch)
        total = steps * self.batch_size

        if self.num_workers <= 0:
            for step in range(steps):
                samples = [
                    _load_one(self.dataset, int(order[i]), seeds[i], n,
                              self.max_retries)
                    for i in range(step * self.batch_size,
                                   (step + 1) * self.batch_size)
                ]
                yield _stack(samples)
            return

        self._ensure_pool()
        window = self.prefetch_batches * self.batch_size + self.num_workers
        submitted = 0
        done = 0
        buf: Dict[int, dict] = {}
        next_emit = 0
        pending_batch = []
        try:
            while done < total:
                while submitted < total and submitted - done < window:
                    self._task_q.put(
                        (submitted, int(order[submitted]), seeds[submitted])
                    )
                    submitted += 1
                seq, sample = self._next_result()
                if isinstance(sample, Exception):
                    raise sample
                buf[seq] = sample
                while next_emit in buf:
                    pending_batch.append(buf.pop(next_emit))
                    next_emit += 1
                    done += 1
                    if len(pending_batch) == self.batch_size:
                        yield _stack(pending_batch)
                        pending_batch = []
        except GeneratorExit:
            # consumer stopped mid-epoch: drain what the workers still owe
            # so seq numbers can't leak into the next epoch's reorder buffer
            while done < submitted:
                try:
                    self._out_q.get(timeout=30)
                except queue.Empty:  # pragma: no cover
                    self.close()
                    break
                done += 1
            raise


def _stack(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def build_loader(dataset, batch_size, **kw) -> TrainLoader:
    return TrainLoader(dataset, batch_size, **kw)
