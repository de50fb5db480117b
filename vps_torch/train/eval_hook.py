"""Train-time validation hook (port of vps_tpu/train/eval_hook.py; the
reference's DistEvalHook, mmdet ``core/evaluation/eval_hooks.py``):

- whole videos, not frames (the track state is per video), are shared out
  over the ranks: rank r takes the videos v with v % world == r, as the JAX
  hook shares them over hosts;
- each rank runs its videos frame by frame through the detector's
  per-frame carry (``make_frame_step``), in order;
- the results meet in the work dir as in the reference's tmpdir barrier:
  every rank publishes its pickle atomically, rank 0 waits for the others,
  merges, and an ``evaluate`` callable turns the merge into metrics.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Callable, Dict, Optional

import numpy as np

from vps_torch.train import dist


def file_exchange_gather(
    work_dir: str,
    epoch: int,
    results: Dict,
    host: int,
    n_hosts: int,
    barrier_timeout: float = 3600.0,
    poll_interval: float = 1.0,
) -> Dict:
    """The reference's tmpdir result barrier (per-rank dump, barrier, rank-0
    load and merge) as a file exchange: every host atomically publishes its
    results pickle; host 0 polls for all peers (TimeoutError past
    ``barrier_timeout``: a dead peer must not hang training forever) and
    returns the merge. Non-zero hosts return {}."""
    tmpdir = os.path.join(work_dir, ".eval_hook")
    os.makedirs(tmpdir, exist_ok=True)
    part = os.path.join(tmpdir, f"epoch{epoch}.host{host}.pkl")
    with open(part + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(part + ".tmp", part)  # atomic: file visible == complete

    if host != 0:
        return {}
    merged = dict(results)
    deadline = time.time() + barrier_timeout
    for h in range(1, n_hosts):
        p = os.path.join(tmpdir, f"epoch{epoch}.host{h}.pkl")
        while not os.path.exists(p):
            if time.time() > deadline:
                raise TimeoutError(f"eval barrier: missing {p}")
            time.sleep(poll_interval)
        with open(p, "rb") as f:
            merged.update(pickle.load(f))
    return merged


def rank_videos(n_frames: int, nspan: int, rank: int, world: int):
    """The videos of ``rank``: v with v % world == rank, of the
    ceil(n_frames / nspan) videos of ``nspan`` frames each."""
    n_videos = (n_frames + nspan - 1) // nspan
    return [v for v in range(n_videos) if v % world == rank]


def make_video_eval_hook(
    detector,
    dataset,
    work_dir: Optional[str] = None,
    track_cap: int = 256,
    evaluate: Optional[Callable] = None,
    keep_keys=("panoptic_outputs", "fcn_outputs", "num_keep"),
    barrier_timeout: float = 3600.0,
):
    """Returns eval_fn(state, epoch) -> metrics dict for Runner(eval_fn=...).

    The rank and the world size are ``vps_torch.train.dist``'s when the
    hook runs. ``work_dir`` holds the exchange (``.eval_hook/``); it may be
    None only on one rank, which then keeps its results in memory.
    ``evaluate(results, epoch)`` receives {frame_id: {key: np.ndarray}}
    merged over the ranks (rank 0 only; the others get {}) and returns a
    metrics dict. Default: the fraction of frames with any detection, a
    smoke-level metric; pass a VPQ-backed callable for real validation.
    """
    nspan = getattr(dataset, "nframes_span_test", 1) or 1

    def eval_fn(state, epoch: int) -> Dict[str, float]:
        from vps_torch.models.detectors import make_frame_step

        rank, world = dist.get_rank(), dist.get_world_size()
        if work_dir is None and world > 1:
            raise ValueError("the eval hook needs a work_dir across ranks")
        n = len(dataset)
        step = make_frame_step(detector, track_cap=track_cap)
        results: Dict[object, Dict[str, np.ndarray]] = {}
        for v in rank_videos(n, nspan, rank, world):
            for idx in range(v * nspan, min((v + 1) * nspan, n)):
                img, ref_img, meta = dataset.prepare_test(idx)
                outputs = step(img, ref_img, meta["is_first"])
                results[meta["iid"]] = {k: outputs[k].cpu().numpy()
                                        for k in keep_keys if k in outputs}
        if work_dir is not None:
            results = file_exchange_gather(
                work_dir, epoch, results, rank, world,
                barrier_timeout=barrier_timeout)
        if rank != 0:
            return {}
        if evaluate is not None:
            return evaluate(results, epoch)
        if not results:
            return {"eval_frames": 0.0}
        det_frac = float(np.mean([
            float(r.get("num_keep", 0)) > 0 for r in results.values()
        ]))
        return {"eval_frames": float(len(results)),
                "eval_det_frac": det_frac}

    return eval_fn
