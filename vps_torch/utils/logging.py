"""Rank-0 logging and seeding (the port's copy of the JAX package's
``utils/logging.py``; mmdet ``apis/env.py``): rank 0 logs at the given
level, every other rank at ERROR only."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch

from vps_torch.train import dist

FORMAT = "%(asctime)s - %(levelname)s - %(message)s"


def get_root_logger(log_level=logging.INFO, log_file=None):
    """The ``vps_torch`` logger, to the console and (``log_file``) a file.
    The rank is ``torch.distributed``'s when a process group exists, else
    0. A logger that already has handlers is returned as it is; the caller
    that is done with it removes them (``close_root_logger``)."""
    logger = logging.getLogger("vps_torch")
    if logger.handlers:
        return logger
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(h)
    logger.setLevel(log_level if dist.get_rank() == 0 else logging.ERROR)
    logger.propagate = False
    return logger


def close_root_logger() -> None:
    """Remove and close the ``vps_torch`` logger's handlers and give back
    its default level and propagation, so that the next ``get_root_logger``
    (another run in this process) sets them anew."""
    logger = logging.getLogger("vps_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.NOTSET)
    logger.propagate = True


def set_random_seed(seed: int) -> None:
    """Seed ``random``, numpy and torch (every device's generator)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
