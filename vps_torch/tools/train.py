"""Train a detector on one device (the port's counterpart of the repo's
``tools/train.py``).

    python -m vps_torch.tools.train CONFIG [--work_dir D] [--load_from CKPT]
        [--resume_from CKPT] [--seed N] [--total_epochs N] [--batch_size N]
        [--bf16-compute] [--device cuda|cpu]

CONFIG is a port config (``vps_torch/configs/``, or a file whose ``_base_``
names one). The model trains in f32 (``zoo.f32_compute_overrides``, as the
JAX trainer does) unless ``--bf16-compute``; weights start from
``random_init_`` with the seed unless ``--load_from`` or ``--resume_from``
gives a checkpoint of the port's own format. Checkpoints and ``train.log``
go to the work dir. Runs on the card unless ``--device cpu``. Steps run
under ``vps_torch.utils.numerics.train_policy`` (the Runner's), so a run
repeats bit for bit from the same seed; the tool sets
``CUBLAS_WORKSPACE_CONFIG`` before it touches the card, as the policy
needs.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch

from vps_torch import resolve_device, zoo
from vps_torch.config import Config
from vps_torch.data import build_dataset, build_loader
from vps_torch.models.detectors import build_detector, random_init_
from vps_torch.train.eval_hook import make_video_eval_hook
from vps_torch.train.runner import Runner
from vps_torch.utils.numerics import (
    describe,
    deterministic_cublas,
    f32_policy,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a VPS detector")
    p.add_argument("config")
    p.add_argument("--work_dir")
    p.add_argument("--load_from")
    p.add_argument("--resume_from")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--total_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--bf16-compute", dest="bf16_compute", action="store_true",
                   help="keep the config's bf16 compute_dtype knobs for "
                        "training instead of the f32 default")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _log_handlers(logger, log_file):
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler(), logging.FileHandler(log_file)]
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(logging.INFO)
    return handlers


def main(argv=None):
    """Returns the Runner after its run (its ``log_history`` holds every
    logged step)."""
    args = parse_args(argv)
    numerics = f32_policy()
    deterministic_cublas()  # before CUDA: the Runner trains under train_policy
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    logger = logging.getLogger("vps_torch")
    handlers = _log_handlers(logger, os.path.join(work_dir, "train.log"))
    loader = None
    try:
        seed = args.seed if args.seed is not None else 0
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        model_cfg = cfg.model
        if not args.bf16_compute:
            model_cfg = zoo.f32_compute_overrides(dict(model_cfg))
        det = random_init_(build_detector(model_cfg, cfg.train_cfg,
                                          cfg.test_cfg, device), seed)
        dataset = build_dataset(cfg.data["train"])
        loader = build_loader(dataset, args.batch_size, seed=seed,
                              num_workers=cfg.data.get("workers_per_gpu", 2))
        logger.info(f"device={device} batch={args.batch_size} "
                    f"steps/epoch={loader.steps_per_epoch()}; "
                    f"{describe(numerics)}")

        eval_fn = None
        eval_interval = 1
        ev = cfg.get("evaluation")
        if ev and cfg.data.get("val"):
            val_cfg = dict(cfg.data["val"])
            val_cfg.setdefault("test_mode", True)
            eval_fn = make_video_eval_hook(
                det, build_dataset(val_cfg),
                track_cap=ev.get("track_cap", 256))
            eval_interval = ev.get("interval", 1)

        runner = Runner(
            det, loader, cfg, work_dir,
            total_epochs=args.total_epochs or cfg.get("total_epochs", 12),
            log_interval=cfg.get("log_config", {}).get("interval", 10),
            ckpt_interval=cfg.get("checkpoint_config", {}).get("interval", 4),
            seed=seed, eval_fn=eval_fn, eval_interval=eval_interval)
        runner.run(load_from=args.load_from or cfg.get("load_from"),
                   resume_from=args.resume_from or cfg.get("resume_from"))
        return runner
    finally:
        if loader is not None:
            loader.close()
        for h in handlers:
            logger.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
