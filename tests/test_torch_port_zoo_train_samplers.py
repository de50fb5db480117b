"""Port parity, the R-CNN zoo's samplers: each of the six types through
``sample_from_cfg`` (RandomSampler, PseudoSampler, OHEMSampler,
InstanceBalancedPosSampler, IoUBalancedNegSampler with and without a floor,
CombinedSampler), the port's against vps_tpu's on the same assignment,
the port's ``uniform`` fed JAX's own draws from the key (rp, then rn, as
``jax.random.split`` gives them). The assignment has ties everywhere they
can be: gts with many candidates, overlaps on the IoU bins' edges, equal
OHEM losses; capacities both above and below the candidates. Equal slots,
positive prefix, validity and counts.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vps_tpu.core.assigner import AssignResult as JAssign
from vps_tpu.core.targets import sample_from_cfg as j_sample_from_cfg

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_torch.core.sampler as tsampler
from vps_torch.core.assigner import AssignResult
from vps_torch.core.targets import sample_from_cfg

CFGS = [
    dict(type="RandomSampler", num=16, pos_fraction=0.25),
    dict(type="PseudoSampler", num=48, pos_fraction=0.25),
    dict(type="PseudoSampler", num=12, pos_fraction=0.25),
    dict(type="OHEMSampler", num=16, pos_fraction=0.25),
    dict(type="InstanceBalancedPosSampler", num=24, pos_fraction=0.5),
    dict(type="IoUBalancedNegSampler", num=20, pos_fraction=0.25,
         floor_thr=-1, floor_fraction=0, num_bins=3),
    dict(type="IoUBalancedNegSampler", num=20, pos_fraction=0.25,
         floor_thr=0.1, floor_fraction=0, num_bins=2),
    dict(type="CombinedSampler", num=24, pos_fraction=0.25),
    dict(type="CombinedSampler", num=64, pos_fraction=0.5),
]


def _assignment(n=40):
    rng = np.random.RandomState(11)
    gi = rng.choice([-1, 0, 0, 0, 1, 1, 2, 3], n).astype(np.int32)
    # overlaps on a 1/12 grid: the bins' edges (0, 1/6, 1/3 of 0.5 and the
    # floor's) among them
    mo = (rng.randint(0, 12, n) / 12.0).astype(np.float32)
    mo[gi > 0] = np.maximum(mo[gi > 0], 0.5)
    losses = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    return gi, mo, losses


def test_every_sampler_through_sample_from_cfg_equals_jax():
    gi, mo, losses = _assignment()
    for i, cfg in enumerate(CFGS):
        key = jax.random.PRNGKey(i)
        kp, kn = jax.random.split(key)
        n = gi.shape[0]
        draws = np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                          np.asarray(jax.random.uniform(kn, (n,)))])
        want = j_sample_from_cfg(
            key, cfg, JAssign(jnp.asarray(gi), jnp.asarray(mo), None, None),
            loss_fn=lambda a: jnp.asarray(losses))
        calls = []

        def feed(gen, shape, device):
            calls.append(tuple(shape))
            return torch.from_numpy(draws)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsampler, "uniform", feed)
            got = sample_from_cfg(
                None, cfg, AssignResult(torch.from_numpy(gi),
                                        torch.from_numpy(mo), None, None),
                loss_fn=lambda a: torch.from_numpy(losses))
        random = cfg["type"] not in ("PseudoSampler", "OHEMSampler")
        assert calls == ([(2, n)] if random else []), cfg
        for name in ("inds", "pos_mask", "valid", "num_pos", "num_neg"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{cfg} {name}")
        npos = int(got.num_pos)
        assert got.pos_mask[:npos].all() and not got.pos_mask[npos:].any()
        assert npos <= int(cfg["num"] * cfg["pos_fraction"]) or \
            cfg["type"] == "PseudoSampler"
    with pytest.raises(KeyError):
        sample_from_cfg(None, dict(type="NoSuchSampler", num=4,
                                   pos_fraction=0.5),
                        AssignResult(torch.from_numpy(gi),
                                     torch.from_numpy(mo), None, None))
