"""Port parity, the six remaining losses of vps_tpu/ops/losses.py
(``mse_loss``, ``balanced_l1_loss``, ``bounded_iou_loss``, ``giou_loss``,
``ghm_c_loss``, ``ghm_r_loss``): the same seeded inputs through vps_tpu's
and vps_torch's, values within 1e-6 relative and gradients (JAX's
``jax.grad``, the port's autograd) within 1e-6 of the largest. The GHM
inputs put values on bin edges: a logit of 0 against a positive (g = 0.5),
saturated logits (g = 0 and g = 1), a logit whose g is 0.9 in f32 (under
jnp.linspace's edge 0.90000004, over torch.linspace's 0.9), a zero and a
huge regression error (g = 0 and g = 1), so a bin edge built otherwise
than jnp.linspace's changes the loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vps_tpu.ops.losses as jl

import vps_torch.ops.losses as tl
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def _boxes(rng, n):
    xy = rng.uniform(0, 60, (n, 2)).astype(np.float32)
    wh = rng.uniform(2, 40, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


def _inputs(name, rng):
    """(differentiated input, other positional inputs, keyword inputs)."""
    n = 40
    weight = (rng.uniform(size=n) > 0.3).astype(np.float32)
    if name in ("mse_loss", "balanced_l1_loss"):
        pred = rng.normal(size=(n, 4)).astype(np.float32)
        target = rng.normal(size=(n, 4)).astype(np.float32)
        kw = dict(weight=weight[:, None], avg_factor=np.float32(7.0))
        if name == "balanced_l1_loss":
            kw.update(beta=1.0, alpha=0.5, gamma=1.5)
        return pred, (target,), kw
    if name in ("bounded_iou_loss", "giou_loss"):
        target = _boxes(rng, n)
        pred = target + rng.normal(scale=4.0, size=(n, 4)).astype(np.float32)
        pred[:3] = target[:3]  # exact matches
        kw = dict(weight=weight, avg_factor=np.float32(9.0))
        if name == "bounded_iou_loss":
            kw.update(beta=0.2)
        return pred, (target,), kw
    if name == "ghm_c_loss":
        logits = rng.normal(scale=3.0, size=(n, 5)).astype(np.float32)
        labels = rng.randint(0, 6, n).astype(np.int32)
        labels[:4] = 1
        logits[:4, 0] = [0.0, 30.0, -30.0, 0.0]  # g = 0.5, 0, 1, 0.5
        logits[4, :] = 30.0  # negatives' g = 1
        labels[5] = 1
        logits[5, 1] = 2.197224  # a negative's g = float32(0.9)
        valid = rng.uniform(size=n) > 0.2
        valid[:6] = True
        return logits, (labels, valid), dict(bins=10)
    pred = rng.normal(scale=0.05, size=(n, 4)).astype(np.float32)
    target = rng.normal(scale=0.05, size=(n, 4)).astype(np.float32)
    pred[0] = target[0]  # g = 0
    pred[1] = target[1] + 1e6  # g = 1
    valid = rng.uniform(size=n) > 0.2
    return pred, (target, valid), dict(mu=0.02, bins=10)


@pytest.mark.parametrize("name", ["mse_loss", "balanced_l1_loss",
                                  "bounded_iou_loss", "giou_loss",
                                  "ghm_c_loss", "ghm_r_loss"])
def test_loss_and_grad_match_jax(name):
    x, args, kw = _inputs(name, np.random.RandomState(3))
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    want, jgrad = jax.value_and_grad(lambda v: jfn(
        v, *(jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))(jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    got = tfn(tx, *(torch.from_numpy(np.array(a)) for a in args),
              **{k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                 else v for k, v in kw.items()})
    got.backward()
    assert np.isfinite(float(want)) and float(want) != 0.0
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6,
                                                abs=0)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
