"""Port, data-parallel training: one train step of the tiny FuseTrack on 2
gloo ranks (one sample each, global batch 2) against the same step in one
process on the batch of 2, on the CPU.

Both run ``make_train_step`` from the same weights (rank 1 gets rank 0's
through ``broadcast_module``) and the same step generator; each sample
draws from its own generator, keyed by its index in the global batch, so
the ranks' forwards are the one process's forwards. The gradients then
differ only in the order of their sums (the one process sums both samples'
contributions to a weight in one backward). The file's only test: it is
heavy for a file with several (pytest-xdist's loadfile queues files by
their number of tests, most first).
"""

import numpy as np
import torch

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from torch_dist_parity import (SEED, batch_of, finish, rank_procs, sample,
                               tiny_det)

from vps_torch.train.optim import build_optimizer
from vps_torch.train.step import TrainState, make_train_step


def _one_process(state_dict, samples):
    det = tiny_det(state_dict)
    opt = build_optimizer(det, lambda step: np.float32(0.01))[0]
    grads = {}
    real_step = opt.step

    def step():
        grads.update({n: p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p)
                      for n, p in zip(opt.names, opt.params)})
        return real_step()

    opt.step = step
    _, log_vars = make_train_step(det, opt)(
        TrainState(opt, 0), batch_of(samples), torch.Generator().manual_seed(SEED))
    return ({k: float(v) for k, v in log_vars.items()}, grads,
            {n: p.detach() for n, p in det.named_parameters()})


def test_two_rank_step_matches_one_process_batch_of_two(tmp_path):
    """Loss terms (averaged over the ranks) within 1e-6 relative; each
    all-reduced gradient within 1e-5 of its tensor's largest plus 1e-7 of
    the largest over all tensors; each parameter after the update within
    1e-6 of its tensor's largest (f32 sums in other orders: measured at
    most ~1e-7 for the gradients); the two ranks equal bit for bit."""
    state_dict = tiny_det().state_dict()
    samples = [sample(np.random.RandomState(r + 1)) for r in range(2)]
    torch.save({"state_dict": state_dict, "samples": samples},
               tmp_path / "inputs.pt")
    procs = rank_procs("step", 2, tmp_path)
    try:
        want_logs, want_grads, want_params = _one_process(state_dict, samples)
    finally:
        finish(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name])
    for name in ranks[0]["grads"]:
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name])
    assert ranks[0]["log_vars"] == ranks[1]["log_vars"]

    got_logs = ranks[0]["log_vars"]
    assert set(got_logs) == set(want_logs)
    for k, v in want_logs.items():
        assert np.isfinite(v), k
        assert abs(got_logs[k] - v) <= 1e-6 * max(abs(v), 1e-3), (k, got_logs[k], v)
    grads = ranks[0]["grads"]
    assert set(grads) == set(want_grads)
    gmax = max(g.abs().max().item() for g in want_grads.values())
    assert gmax > 0
    for name, want in want_grads.items():
        err = (grads[name] - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() + 1e-7 * gmax, (name, err)
    params = ranks[0]["params"]
    moved = 0
    for name, want in want_params.items():
        err = (params[name] - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), (name, err)
        moved += not torch.equal(want, state_dict[name])
    assert moved == len(grads)
