"""Data-parallel training across processes (the port's counterpart of the
JAX package's ``make_mesh``, ``shard_batch`` and ``replicate`` in
``train/step.py``; the reference's DDP over NCCL: mmdet ``apis/env.py``
``init_dist`` and ``core/utils/dist_utils.py`` ``allreduce_grads``).

One process a card (a rank), each with its own shard of the data
(``TrainLoader(num_hosts=world, host_id=rank)``). Every rank starts from
rank 0's weights (``broadcast_module``); after each backward the trainable
set's gradients are averaged over the ranks (``all_reduce_grads``), so
every rank's optimizer sees the global batch's gradient and the replicas
stay equal bit for bit.

Nothing here falls back: a rank without its card, or a backend that fails
to start, raises. Without a process group every function is a no-op and
``get_rank`` / ``get_world_size`` read 0 / 1.
"""

from __future__ import annotations

import datetime
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

DEFAULT_PORT = 29500  # the reference's (mmcv _init_dist_slurm)
# a collective that waits longer raises (torch's default for both backends)
TIMEOUT = datetime.timedelta(minutes=30)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def _slurm_master_addr() -> str:
    """The first host of the job's node list (mmcv's ``scontrol show
    hostname $SLURM_NODELIST | head -n1``)."""
    out = subprocess.run(
        ["scontrol", "show", "hostname", os.environ["SLURM_NODELIST"]],
        capture_output=True, text=True, check=True).stdout.split()
    if not out:
        raise RuntimeError("scontrol listed no host for SLURM_NODELIST")
    return out[0]


def rendezvous_from_env() -> Tuple[str, int, int, int]:
    """(init_method, world size, rank, local rank) from torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK``
    or SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID`` (the
    master address from ``MASTER_ADDR``, else the job's first host; the
    port from ``MASTER_PORT``, else 29500)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError("RANK and WORLD_SIZE are set but MASTER_ADDR "
                               "or MASTER_PORT is not")
        return (f"tcp://{addr}:{port}", int(env["WORLD_SIZE"]),
                int(env["RANK"]), int(env.get("LOCAL_RANK", 0)))
    if "SLURM_PROCID" in env:
        addr = env.get("MASTER_ADDR") or _slurm_master_addr()
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return (f"tcp://{addr}:{port}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]), int(env.get("SLURM_LOCALID", 0)))
    raise RuntimeError("no rendezvous: pass coordinator, num_processes and "
                       "process_id, or run under torchrun (RANK, WORLD_SIZE, "
                       "MASTER_ADDR, MASTER_PORT) or SLURM (SLURM_PROCID, "
                       "SLURM_NTASKS)")


def rank_device(device: str, local_rank: int) -> torch.device:
    """The rank's device: ``cuda`` without an index is ``cuda:LOCAL_RANK``;
    ``cuda:N`` puts every rank on card N; ``cpu`` is the CPU. A card that
    is not there raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank device {dev}: torch.cuda.is_available() is "
                           f"False")
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank device {dev}: this host has "
                           f"{torch.cuda.device_count()} card(s)")
    return dev


def init_dist(backend: str, coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None) -> Tuple[int, int, int]:
    """Join the process group; returns (rank, world size, local rank).

    With ``coordinator`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` the rendezvous is ``tcp://coordinator`` (local rank:
    ``LOCAL_RANK`` if set, else the process id: the ranks of one host, as
    ``tools/dist_train.sh`` starts them); otherwise it comes from the
    environment (``rendezvous_from_env``). ``backend`` is ``nccl`` (the
    card) or ``gloo`` (the CPU, or the card when asked for: gloo puts
    several ranks on one card, NCCL does not). A collective that waits
    longer than ``TIMEOUT`` raises."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    explicit = (coordinator, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("coordinator, num_processes and process_id go "
                             "together")
        method = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        method, world, rank, local = rendezvous_from_env()
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend nccl needs a card; "
                           "torch.cuda.is_available() is False")
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return rank, world, local


def destroy_dist() -> None:
    if is_distributed():
        dist.destroy_process_group()


def _by_kind(tensors: Sequence[torch.Tensor]) -> Dict[tuple, List[int]]:
    """Indices of ``tensors`` grouped by (dtype, device), in order."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src`` to every
    rank (the JAX package's ``replicate``): flat buffers, one a dtype."""
    if not is_distributed():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for idx in _by_kind(tensors).values():
        group = [tensors[i].data for i in idx]
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Average the gradients of ``params`` over the ranks: packed in the
    given order into one flat buffer a dtype, summed by one all-reduce,
    divided by the world size, unpacked into ``.grad`` (the reference's
    coalesced ``allreduce_grads``). A parameter without a gradient counts
    as zeros, so every rank's buffer has the same layout."""
    if not is_distributed():
        return
    world = get_world_size()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for idx in _by_kind(grads).values():
        group = [grads[i] for i in idx]
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        flat.div_(world)
        for i, g in zip(idx, _unflatten_dense_tensors(flat, group)):
            params[i].grad = g


@torch.no_grad()
def reduce_log_vars(log_vars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The logged scalars averaged over the ranks (mmdet ``parse_losses``
    under DDP), in one all-reduce of the sorted keys' values."""
    if not is_distributed():
        return log_vars
    keys = sorted(log_vars)
    flat = torch.stack([log_vars[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat.div_(get_world_size())
    return dict(zip(keys, flat.unbind()))
