"""The port's deterministic training (``vps_torch.utils.numerics.
train_policy``): the policy's flags, set and given back, and its cuBLAS
guard; the two backwards that PyTorch has no deterministic form of on the
card, each held against the library's backward on the CPU (the same
forward bit for bit; gradients within 1e-6 of the library gradient's
largest element in f32, where only the order of the sums differs, and
within 1e-12 in f64): ``grid_sample_deterministic``
(bilinear and nearest, points outside the input and on integers) and
``adaptive_max_pool_deterministic`` (overlapping windows, ties); and
``flow_warp`` under the policy against JAX's VJP of vps_tpu's
``flow_warp``.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vps_tpu.ops.warp import flow_warp as j_flow_warp

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models import layers
from vps_torch.ops.warp import flow_warp, grid_sample_deterministic
from vps_torch.utils import numerics


def _grads(fn, inputs, g):
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, g)


def test_train_policy_and_deterministic_backwards():
    # the policy: every flag on inside, every flag given back after
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    with numerics.train_policy() as s:
        assert s["deterministic_algorithms"] and s["cudnn.deterministic"]
        assert not s["cudnn.benchmark"] and not s["cudnn.allow_tf32"]
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == flags
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        assert numerics.deterministic_cublas() == ":4096:8"
        mp.delenv("CUBLAS_WORKSPACE_CONFIG")
        mp.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
            with numerics.train_policy():
                pass
        assert not torch.are_deterministic_algorithms_enabled()

    # grid_sample: grid points outside the input, on integer pixels, and
    # random ones, both modes
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 9, 11, generator=gen)
    grid = torch.rand(2, 7, 8, 2, generator=gen) * 2.6 - 1.3
    grid[0, 0] = torch.stack([(2 * torch.arange(8) + 1) / 11 - 1,
                              torch.full((8,), 3 / 9 - 1)], -1)
    g = torch.randn(2, 5, 7, 8, generator=gen)
    for mode in ("bilinear", "nearest"):
        for dt, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
            args = (x.to(dt), grid.to(dt))
            want, gw = _grads(lambda a, b: F.grid_sample(
                a, b, mode=mode, padding_mode="zeros", align_corners=False),
                args, g.to(dt))
            got, gg = _grads(
                lambda a, b: grid_sample_deterministic(a, b, mode), args,
                g.to(dt))
            assert torch.equal(got, want), mode
            for a, b in zip(gg, gw):
                scale = float(b.abs().max()) if dt == torch.float32 else 1.0
                torch.testing.assert_close(a, b, rtol=0, atol=tol * scale)

    # adaptive max pool: windows that overlap (13 -> 5, 11 -> 4) and a
    # constant block, where the first maximum wins
    x = torch.randn(2, 3, 13, 11, generator=gen)
    x[:, :, :4, :4] = 0.5
    g = torch.randn(2, 3, 5, 4, generator=gen)
    want, (gw,) = _grads(lambda a: F.adaptive_max_pool2d(a, (5, 4)), (x,), g)
    got, (gp,) = _grads(
        lambda a: layers.adaptive_max_pool_deterministic(a, (5, 4)), (x,), g)
    assert torch.equal(got, want)
    torch.testing.assert_close(gp, gw, rtol=0, atol=1e-6)
    with numerics.train_policy():
        out = layers.adaptive_max_pool(x.clone().requires_grad_(), (5, 4))
        assert "AdaptiveMaxPoolDeterministic" in type(out.grad_fn).__name__

    # flow_warp under the policy against JAX's VJP (NHWC)
    rng = np.random.RandomState(1)
    feat = rng.randn(1, 12, 16, 6).astype(np.float32)
    flow = (rng.randn(1, 12, 16, 2) * 3).astype(np.float32)
    gout = rng.randn(1, 12, 16, 6).astype(np.float32)
    jout, vjp = jax.vjp(j_flow_warp, jnp.asarray(feat), jnp.asarray(flow))
    jgf, jgflow = vjp(jnp.asarray(gout))
    with numerics.train_policy():
        tf = torch.from_numpy(feat).requires_grad_()
        tflow = torch.from_numpy(flow).requires_grad_()
        out = flow_warp(tf, tflow)
        assert "GridSampleDeterministic" in str(out.grad_fn.next_functions)
        out.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tflow.grad.numpy(), np.asarray(jgflow),
                               rtol=0, atol=1e-4 * np.abs(jgflow).max())
