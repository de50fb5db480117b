"""Train a detector on one card or data-parallel across processes (the
port's counterpart of the repo's ``tools/train.py``).

    python -m vps_torch.tools.train CONFIG [--work_dir D] [--load_from CKPT]
        [--resume_from CKPT] [--seed N] [--total_epochs N] [--batch_size N]
        [--bf16-compute] [--device cuda|cuda:N|cpu]
        [--distributed | --coordinator HOST:PORT --num_processes N
         --process_id I] [--dist-backend nccl|gloo]
        [--launch-counts DIR]

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

Across processes (``vps_torch/tools/dist_train.sh``, ``slurm_train.sh``):
``--coordinator``, ``--num_processes`` and ``--process_id`` give the
rendezvous (they imply ``--distributed``); ``--distributed`` alone takes it
from torchrun's or SLURM's environment. Each process is a rank with
``--batch_size`` samples a step (one image a card, the reference's
recipe) from its own shard of the data; a rank runs on ``cuda:LOCAL_RANK``
unless ``--device`` names one card for every rank. The backend is NCCL on
the card and gloo on the CPU; ``--dist-backend gloo`` puts several ranks on
one card (NCCL refuses that). Only rank 0 logs below ERROR and saves
checkpoints; the validation hook shards the videos over the ranks.
``--launch-counts DIR``: each rank writes the port kernels' launch counts
of its run to ``DIR/launches.rank<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from vps_torch import resolve_device, zoo
from vps_torch.config import Config
from vps_torch.data import build_dataset, build_loader
from vps_torch.models.detectors import build_detector, random_init_
from vps_torch.ops import launch_counts
from vps_torch.train import dist
from vps_torch.train.eval_hook import make_video_eval_hook
from vps_torch.train.runner import Runner
from vps_torch.utils.logging import (
    close_root_logger,
    get_root_logger,
    set_random_seed,
)
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
    p.add_argument("--device", default="cuda",
                   help="cuda: each rank on cuda:LOCAL_RANK; cuda:N: every "
                        "rank on card N; cpu")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of several, the rendezvous from torchrun's "
                        "or SLURM's environment")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (explicit rendezvous, with "
                        "--num_processes and --process_id)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist-backend", dest="dist_backend", default=None,
                   choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--launch-counts", dest="launch_counts", default=None,
                   help="write this rank's kernel launch counts to "
                        "DIR/launches.rank<r>.json")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the Runner after its run (its ``log_history`` holds every
    logged step)."""
    args = parse_args(argv)
    numerics = f32_policy()
    deterministic_cublas()  # before CUDA: the Runner trains under train_policy
    distributed = args.distributed or args.coordinator is not None
    if distributed:
        backend = args.dist_backend or (
            "gloo" if args.device == "cpu" else "nccl")
        rank, world, local = dist.init_dist(
            backend, args.coordinator, args.num_processes, args.process_id)
    elif args.dist_backend is not None:
        raise ValueError("--dist-backend needs --distributed or "
                         "--coordinator")
    else:
        rank, world = 0, 1
    loader = None
    try:
        if distributed:
            device = dist.rank_device(args.device, local)
            if device.type == "cuda":
                torch.cuda.set_device(device)
        else:
            device = resolve_device(args.device)
        cfg = Config.fromfile(args.config)
        work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
        os.makedirs(work_dir, exist_ok=True)
        logger = get_root_logger(log_file=os.path.join(work_dir, "train.log"))
        seed = args.seed if args.seed is not None else 0
        set_random_seed(seed)

        model_cfg = cfg.model
        if not args.bf16_compute:
            model_cfg = zoo.f32_compute_overrides(dict(model_cfg))
        det = random_init_(build_detector(model_cfg, cfg.train_cfg,
                                          cfg.test_cfg, device), seed)
        dataset = build_dataset(cfg.data["train"])
        loader = build_loader(dataset, args.batch_size, seed=seed,
                              num_hosts=world, host_id=rank,
                              num_workers=cfg.data.get("workers_per_gpu", 2))
        logger.info(f"devices={world} hosts={world} "
                    f"batch/host={args.batch_size} "
                    f"steps/epoch={loader.steps_per_epoch()} device={device}"
                    f"{' backend=' + backend if distributed else ''}; "
                    f"{describe(numerics)}")

        eval_fn = None
        eval_interval = 1
        ev = cfg.get("evaluation")
        if ev and cfg.data.get("val"):
            val_cfg = dict(cfg.data["val"])
            val_cfg.setdefault("test_mode", True)
            eval_fn = make_video_eval_hook(
                det, build_dataset(val_cfg), work_dir,
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
        if args.launch_counts:
            os.makedirs(args.launch_counts, exist_ok=True)
            with open(os.path.join(args.launch_counts,
                                   f"launches.rank{rank}.json"), "w") as f:
                json.dump(launch_counts(), f)
        return runner
    finally:
        if loader is not None:
            loader.close()
        close_root_logger()
        if distributed:
            dist.destroy_dist()


if __name__ == "__main__":
    main()
