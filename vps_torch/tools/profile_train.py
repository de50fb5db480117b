"""Train-step timing of FuseTrack (the port's counterpart of the repo's
``tools/profile_train.py``): one R-50 FuseTrack step at the reference's
training crop (800x1600, one image) on a synthetic batch.

    python -m vps_torch.tools.profile_train [--size 800x1600] [--iters 3]
        [--max-gt 16] [--f32] [--sections] [--config CONFIG [--workers N]
        [--batch N]] [--device cuda|cpu]

The batch is the JAX tool's, element for element (``synthetic_batch``:
numpy ``RandomState(0)``, 6 valid boxes of ``--max-gt``). The model
computes with the config's bf16 knobs (``compute_dtype`` of the towers) by
default, and with ``zoo.f32_compute_overrides`` (the trainer's default)
under ``--f32``, as the JAX tool does; seeded random weights, SGD at lr
0.005, momentum 0.9, weight decay 1e-4, clip 35. Every step runs under
``vps_torch.utils.numerics.train_policy``, as the Runner's, from the same
weights and optimizer state (restored before each, as JAX's functional
step starts each call from ``state``): the first step, then ``--iters``
timed ones, each ending in a synchronize. Prints every loss term, the
optimizer's ``nonfinite_skips`` and the correlation kernels' launches by
route. ``--sections``: the forward alone (the loss) and forward + backward,
each the least of ``--iters``. ``--config``: the Runner-style loop over the
config's train set (its loader with ``--workers``, default the config's
``workers_per_gpu``, and ``--batch``, default 1), with the share of a step
spent waiting on the loader. Runs on the card unless ``--device cpu``.
JAX's ``--remat`` is not ported: the step peaks far below the card's
memory, and remat was an XLA:TPU workaround.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from vps_torch import resolve_device


def synthetic_batch(h, w, max_gt=16):
    """The JAX tool's batch as numpy arrays: ``RandomState(0)``, 6 valid
    rectangles of ``max_gt`` with labels 1-8 and pids 1-6, random images
    and semantic maps, the reference boxes the current ones."""
    r = np.random.RandomState(0)
    mg, nv = max_gt, 6
    gt_bboxes = np.zeros((mg, 4), np.float32)
    gt_valid = np.zeros((mg,), bool)
    gt_labels = np.zeros((mg,), np.int32)
    gt_masks = np.zeros((mg, h, w), np.float32)
    for i in range(nv):
        x0, y0 = r.randint(0, w - 200), r.randint(0, h - 200)
        bw, bh = r.randint(40, 200), r.randint(40, 200)
        gt_bboxes[i] = [x0, y0, min(x0 + bw, w - 1), min(y0 + bh, h - 1)]
        gt_valid[i] = True
        gt_labels[i] = r.randint(1, 9)
        gt_masks[i, y0:y0 + bh, x0:x0 + bw] = 1.0
    gt_pids = np.zeros((mg,), np.int32)
    gt_pids[:nv] = np.arange(1, nv + 1)
    return dict(
        img=r.randn(1, h, w, 3).astype(np.float32),
        ref_img=r.randn(1, h, w, 3).astype(np.float32),
        gt_bboxes=gt_bboxes[None],
        gt_labels=gt_labels[None],
        gt_valid=gt_valid[None],
        gt_masks=gt_masks[None],
        gt_semantic_seg=r.randint(0, 19, (1, h, w)).astype(np.int32),
        gt_semantic_seg_Nx=r.randint(0, 19, (1, h // 4, w // 4)).astype(
            np.int32),
        gt_pids=gt_pids[None],
        ref_bboxes=gt_bboxes[None],
        ref_valid=gt_valid[None],
    )


def build_model(device, f32=False, depth=50, seed=0):
    """R-``depth`` FuseTrack with ``fusetrack_train_cfg``: the config's bf16
    compute knobs, or ``f32_compute_overrides`` under ``f32``; seeded
    random weights (``seed=None``: as built, for a caller that loads its
    own)."""
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_

    cfg = zoo.fusetrack_model_cfg(depth)
    if f32:
        cfg = zoo.f32_compute_overrides(cfg)
    cfg.pop("type")
    det = PanopticFuseTrack(train_cfg=zoo.fusetrack_train_cfg(),
                            test_cfg=zoo.fusetrack_test_cfg(), device=device,
                            **cfg)
    return det if seed is None else random_init_(det, seed=seed)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stepper:
    """Train steps of ``det`` from one saved state: ``step(batch)`` restores
    the weights and the optimizer's state, then runs one step under
    ``train_policy`` with the generator seeded alike; returns (seconds, the
    loss terms as floats)."""

    def __init__(self, det, lr=0.005):
        from vps_torch.train.optim import build_optimizer
        from vps_torch.train.step import TrainState, make_train_step

        self.det = det
        self.device = torch.device(det.device)
        self.opt, _ = build_optimizer(det, lambda count: lr, momentum=0.9,
                                      weight_decay=1e-4, grad_clip=35.0)
        self.train_step = make_train_step(det, self.opt)
        self.state = TrainState(self.opt, 0)
        self.weights = {k: v.clone() for k, v in det.state_dict().items()}
        self.opt_state = copy.deepcopy(self.opt.state_dict())

    def restore(self):
        self.det.load_state_dict(self.weights)
        self.opt.load_state_dict(copy.deepcopy(self.opt_state))
        self.det.zero_grad(set_to_none=True)

    def generator(self):
        return torch.Generator(device=self.device).manual_seed(0)

    def step(self, batch):
        from vps_torch.utils.numerics import train_policy

        self.restore()
        gen = self.generator()
        with train_policy():
            _sync(self.device)
            t0 = time.perf_counter()
            _, logs = self.train_step(self.state, batch, gen)
            logs = {k: float(v) for k, v in logs.items()}
            _sync(self.device)
        return time.perf_counter() - t0, logs

    def sections(self, batch, iters):
        """The least forward (the loss) and forward + backward seconds over
        ``iters`` runs from the saved state."""
        from vps_torch.train.step import make_loss_fn
        from vps_torch.utils.numerics import train_policy

        loss_fn = make_loss_fn(self.det)
        fwd, fwd_bwd = [], []
        for _ in range(iters):
            for out, backward in ((fwd, False), (fwd_bwd, True)):
                self.restore()
                with train_policy():
                    _sync(self.device)
                    t0 = time.perf_counter()
                    total, _ = loss_fn(batch, self.generator())
                    if backward:
                        total.backward()
                    float(total)
                    _sync(self.device)
                    out.append(time.perf_counter() - t0)
        self.restore()
        return min(fwd), min(fwd_bwd)


def loader_loop(stepper, config, iters, workers=None, batch=None):
    """The Runner's loop over ``config``'s train set: ``iters + 1`` batches,
    each stepped from the saved state; returns (wait s a step, step s a
    step, workers, batch size), the first batch left out."""
    from vps_torch.config import Config
    from vps_torch.data import build_dataset, build_loader
    from vps_torch.train.runner import _to_device

    cfg = Config.fromfile(config)
    bsz = batch or 1
    workers = (workers if workers is not None
               else cfg.data.get("workers_per_gpu", 2))
    loader = build_loader(build_dataset(cfg.data["train"]), bsz, seed=0,
                          num_workers=workers)
    t_wait = t_step = 0.0
    n = 0
    it = loader.epoch(0)
    try:
        while n < iters + 1:
            t0 = time.perf_counter()
            raw = next(it, None)
            wait = time.perf_counter() - t0
            if raw is None:
                break
            dt, _ = stepper.step(_to_device(raw, stepper.device))
            if n > 0:
                t_wait += wait
                t_step += dt
            n += 1
    finally:
        it.close()
        loader.close()
    done = max(n - 1, 1)
    return t_wait / done, t_step / done, workers, bsz


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="FuseTrack train-step timing")
    ap.add_argument("--size", default="800x1600")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-gt", dest="max_gt", type=int, default=16)
    ap.add_argument("--f32", action="store_true",
                    help="zoo.f32_compute_overrides (the trainer's default) "
                         "instead of the config's bf16 knobs")
    ap.add_argument("--sections", action="store_true",
                    help="also time the forward alone and forward + backward")
    ap.add_argument("--config", default=None,
                    help="also time the Runner-style loop (the config's "
                         "train loader + step): the loader-wait share")
    ap.add_argument("--workers", type=int, default=None,
                    help="loader workers for --config (default: the "
                         "config's workers_per_gpu)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch for --config (default 1)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Prints the JAX tool's lines and the port's counts; returns a dict of
    the numbers (``first_s``, ``step_s`` list, ``logs`` of the first step,
    ``launches``, ``nonfinite_skips``, ``peak_bytes``, and ``fwd_s`` /
    ``fwd_bwd_s`` / ``loader`` where asked)."""
    args = parse_args(argv)
    from vps_torch.ops import launch_counts
    from vps_torch.utils.numerics import (
        describe,
        deterministic_cublas,
        f32_policy,
    )

    numerics = f32_policy()
    deterministic_cublas()  # before CUDA: the steps run train_policy
    device = resolve_device(args.device)
    h, w = (int(v) for v in args.size.split("x"))
    on_card = device.type == "cuda"

    t0 = time.perf_counter()
    det = build_model(device, f32=args.f32)
    stepper = Stepper(det)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in synthetic_batch(h, w, args.max_gt).items()}
    _sync(device)
    print(f"init: {time.perf_counter() - t0:.1f}s "
          f"({'f32' if args.f32 else 'bf16'} compute, {h}x{w}, max_gt "
          f"{args.max_gt}, {device}; {describe(numerics)})", flush=True)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    first_s, logs = stepper.step(batch)
    counts = launch_counts()
    first_launches = {k: counts[k] - before[k] for k in counts}
    print(f"first step: {first_s:.1f}s  loss={logs['loss']:.3f}", flush=True)
    for k in sorted(logs):
        print(f"  {k:16s} {logs[k]:.4f}", flush=True)
    ts, later = [], []
    for _ in range(args.iters):
        dt, logs_i = stepper.step(batch)
        ts.append(dt)
        later.append(logs_i)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    skips = stepper.opt.total_notfinite
    out = dict(first_s=first_s, step_s=ts, logs=logs, launches=first_launches,
               nonfinite_skips=skips, peak_bytes=peak,
               repeat_equal=all(lg == logs for lg in later))
    if ts:
        print(f"train step {args.size}: {min(ts) * 1000:.0f} ms/iter "
              f"({[f'{t * 1000:.0f}' for t in ts]})", flush=True)
    print(f"nonfinite_skips {skips}; peak mem {peak / 2**30:.2f} GiB; "
          f"correlation launches a step by route: "
          f"corr_bf16_tc {first_launches['corr_bf16_tc']}, corr_f32 "
          f"{first_launches['corr_f32']}, corr_backward "
          f"{first_launches['corr_backward']} (bf16 route "
          f"{first_launches['corr_backward_bf16']})"
          + (f"; the {len(ts) + 1} steps' loss terms from one state "
             f"{'bitwise equal' if out['repeat_equal'] else 'differ'}"
             if ts else ""), flush=True)

    if args.sections:
        fwd, fwd_bwd = stepper.sections(batch, max(args.iters, 1))
        out.update(fwd_s=fwd, fwd_bwd_s=fwd_bwd)
        print(f"  fwd-only: {fwd * 1000:.0f} ms", flush=True)
        step_s = min(ts) if ts else first_s
        print(f"  fwd+bwd: {fwd_bwd * 1000:.0f} ms  (optimizer+skip-guard = "
              f"step - fwd+bwd = {(step_s - fwd_bwd) * 1000:.0f} ms)",
              flush=True)

    if args.config:
        wait, step, workers, bsz = loader_loop(
            stepper, args.config, args.iters, args.workers, args.batch)
        out["loader"] = dict(wait_s=wait, step_s=step, workers=workers,
                             batch=bsz)
        print(f"loader-in-loop ({workers} workers, batch {bsz}): wait "
              f"{wait * 1000:.0f} ms/iter, step {step * 1000:.0f} ms/iter, "
              f"wait/step = {wait / step if step else float('nan'):.3f}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
