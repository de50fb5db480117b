"""Helpers of the port's data-parallel tests (``test_torch_port_dist_*``):
the tiny FuseTrack, its samples, free ports, rank processes with a time
limit, and the rank worker itself.

The worker runs as a script, one process a rank, on the CPU over gloo:

    python tests/torch_dist_parity.py MODE RANK WORLD PORT WORK

It imports torch, numpy and vps_torch only. It reads ``WORK/inputs.pt``
(``state_dict``: the tiny model's weights; ``samples``: one per rank, numpy
dicts as ``sample`` makes them), joins the group through
``vps_torch.train.dist.init_dist`` at ``localhost:PORT`` and writes
``WORK/rank<RANK>.pt``. MODE ``step``: one ``make_train_step`` step on its
sample (log vars, the all-reduced gradients, the parameters after).
MODE ``grads``: the gradients of the selection-free terms, with the sampler's
draws fixed by shape as ``test_torch_port_train.py`` fixes them, after
``all_reduce_grads``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
H, W, G = 64, 128, 4
SELECTION_FREE = ("loss_segm", "loss_rpn_cls", "loss_rpn_bbox")
SEED = 0


def tiny_det(state_dict=None):
    """The tiny FuseTrack of the CPU tests (ResNet-18, TinyFlow, f32 compute,
    ``tiny_train_cfg``) on the CPU: ``state_dict``'s weights, else
    ``random_init_``'s."""
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_

    cfg = zoo.f32_compute_overrides(zoo.tiny_overrides(
        zoo.fusetrack_model_cfg()))
    cfg.pop("type")
    det = PanopticFuseTrack(train_cfg=zoo.tiny_train_cfg(),
                            test_cfg=zoo.fusetrack_test_cfg(), device="cpu",
                            **cfg)
    if state_dict is None:
        return random_init_(det, SEED)
    det.load_state_dict(state_dict, strict=True)
    return det


def sample(rng):
    """One training sample at 64x128 (3 valid gts of 4, rectangle masks, a
    semantic map with ignored rows, pids, shifted reference boxes): the
    sample of ``test_torch_port_train.py``, numpy only."""
    boxes = np.array([[8, 8, 40, 40], [50, 10, 95, 60], [100, 20, 127, 63],
                      [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 0], bool)
    masks = np.zeros((G, H, W), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:3].astype(int)):
        masks[i, y1:y2 + 1, x1:x2 + 1] = 1
    seg = rng.randint(0, 19, (1, H, W)).astype(np.int32)
    seg[:, :8] = 255
    return dict(
        img=rng.randn(1, H, W, 3).astype(np.float32),
        ref_img=rng.randn(1, H, W, 3).astype(np.float32),
        gt_bboxes=boxes, gt_labels=np.array([1, 3, 8, 0], np.int32),
        gt_valid=valid, gt_masks=masks, gt_semantic_seg=seg,
        gt_semantic_seg_Nx=seg[:, ::4, ::4].copy(),
        gt_pids=np.array([1, 0, 2, 0], np.int32),
        ref_bboxes=(boxes + 2.0) * valid[:, None],
        ref_valid=np.array([1, 0, 1, 0], bool))


def batch_of(samples):
    """The batch of ``samples`` as the Runner's loaders give it: the image
    fields concatenated on their batch dim of 1, the gt fields stacked."""
    from vps_torch.train.step import IMAGE_KEYS

    return {k: torch.from_numpy(np.concatenate([s[k] for s in samples])
                                if k in IMAGE_KEYS
                                else np.stack([s[k] for s in samples]))
            for k in samples[0]}


def prios(n):
    """The sampler's draws for n candidates, fixed by n (as
    ``test_torch_port_train.py``'s ``_prios``)."""
    return np.random.RandomState(n).rand(2, n).astype(np.float32)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(cmd, env=None, cwd=None):
    """A process in a session of its own (``finish`` stops the whole
    group, the ranks a launcher started included)."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, cwd=cwd,
                            start_new_session=True)


def finish(procs, timeout=120):
    """Wait for every process (``timeout`` s each); kill all of them if one
    fails or runs over. Returns their outputs; raises on a failure."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
            assert p.returncode == 0, f"rc {p.returncode}:\n{outs[-1][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return outs


def rank_procs(mode, world, work):
    """``world`` worker processes of ``mode`` over ``work``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return [start([sys.executable, str(Path(__file__).resolve()), mode,
                   str(r), str(world), str(port), str(work)], env=env)
            for r in range(world)]


def _worker(mode, rank, world, port, work):
    import vps_torch.core.sampler as tsampler
    from vps_torch.train import dist
    from vps_torch.train.optim import build_optimizer
    from vps_torch.train.step import TrainState, make_loss_fn, make_train_step

    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    dist.init_dist("gloo", f"localhost:{port}", world, rank)
    try:
        # rank 0's weights reach the others through the broadcast
        det = tiny_det(inputs["state_dict"] if rank == 0 else None)
        dist.broadcast_module(det)
        batch = batch_of([inputs["samples"][rank]])
        gen = torch.Generator().manual_seed(SEED)
        out = {}
        if mode == "step":
            opt = build_optimizer(det, lambda step: np.float32(0.01))[0]
            real_step = opt.step

            def step():
                out["grads"] = {n: p.grad.clone()
                                for n, p in zip(opt.names, opt.params)}
                return real_step()

            opt.step = step
            _, log_vars = make_train_step(det, opt)(TrainState(opt, 0),
                                                    batch, gen)
            out["log_vars"] = {k: float(v) for k, v in log_vars.items()}
            out["params"] = {n: p.detach().clone()
                             for n, p in det.named_parameters()}
        else:
            tsampler.uniform = (lambda generator, shape, device:
                                torch.from_numpy(prios(shape[1])))
            _, log_vars = make_loss_fn(det)(batch, gen)
            sum(log_vars[k] for k in SELECTION_FREE).backward()
            params = [p for p in det.parameters() if p.requires_grad]
            dist.all_reduce_grads(params)
            out["grads"] = {n: p.grad.clone()
                            for n, p in det.named_parameters()
                            if p.requires_grad}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_dist()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    m, r, w, p, d = sys.argv[1:6]
    _worker(m, int(r), int(w), int(p), d)
