"""Port parity, the OHEM branch of training: vps_torch's ``ohem_sample``
against vps_tpu's on the same losses (identical slots), and the tiny
FuseTrack's ``loss`` with ``rcnn.sampler = OHEMSampler`` on both stacks
(the weights and sample of test_torch_port_train.py, the same RPN sampler
draws), every term within test_torch_port_train_loss.py's tolerances.

OHEM ranks the candidates by their hard-mining losses, and losses that
differ by float noise between the stacks could swap ranks at the edge of
the selection. So the loss terms are compared only with the selection's
edge (the gap between the last candidate kept and the first left out, for
the positives and for the negatives) asserted wider than the largest
difference between the two stacks' hard-mining losses.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import vps_tpu.core.targets as jtargets
from vps_tpu import zoo as jzoo
from vps_tpu.core.sampler import _sample_by_priority as j_sample_by_priority
from vps_tpu.core.sampler import ohem_sample as j_ohem_sample
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack

from test_torch_port_train import SELECTION_FREE, _cfg, _prios, _sample, _weights
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_torch.core.sampler as tsampler
import vps_torch.core.targets as ttargets
from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.core.sampler import ohem_sample
from vps_torch.models.detectors import PanopticFuseTrack

# fewer slots than the tiny sample has scored candidates (61), so the
# hardest ones are really chosen
OHEM = dict(type="OHEMSampler", num=32, pos_fraction=0.25)


def _train_cfg(zoo_mod):
    cfg = zoo_mod.tiny_train_cfg()
    cfg["rcnn"]["sampler"] = dict(OHEM)
    return cfg


def _same_slots(gi, losses, num, pos_fraction):
    want = j_ohem_sample(jnp.asarray(gi), jnp.asarray(losses), num, pos_fraction)
    got = ohem_sample(torch.from_numpy(gi), torch.from_numpy(losses), num,
                      pos_fraction)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _edge_margin(gi, losses, port_losses, num, pos_fraction):
    """The gap at the selection's edge, for the positives and for the
    negatives: between the last candidate kept and the first left out (inf
    where every candidate of a kind is kept). Where the two are tied (the
    same box twice: proposals clipped alike), the tie must be exact in both
    stacks, so index order breaks it alike, and the gap is the tie's
    distance to its nearest other values."""
    max_pos = int(num * pos_fraction)
    n_pos = int((gi > 0).sum())
    gaps = [np.inf]
    for kind, keep in ((gi > 0, max_pos), (gi == 0, num - min(n_pos, max_pos))):
        vals = np.sort(losses[kind])[::-1]
        if len(vals) <= keep:
            continue
        edge = vals[keep - 1]
        if edge > vals[keep]:
            gaps.append(edge - vals[keep])
            continue
        tied = kind & (losses == edge)
        assert len(set(port_losses[tied].tolist())) == 1, "inexact tie"
        others = np.abs(vals[vals != edge] - edge)
        gaps.append(others.min())
    return min(gaps), n_pos, int((gi == 0).sum())


def test_ohem_matches_jax():
    # the sampler on the same losses, with ties (a stable sort keeps index
    # order), more positives than their share and fewer
    rng = np.random.RandomState(5)
    for n_pos in (40, 5):
        gi = np.full(200, -1, np.int32)
        gi[:n_pos] = rng.randint(1, 4, n_pos)
        gi[n_pos:150] = 0
        rng.shuffle(gi)
        losses = np.round(rng.rand(200), 2).astype(np.float32)
        _same_slots(gi, losses, 64, 0.25)

    params, stats = _weights()
    s = _sample(np.random.RandomState(1))
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsampler, "uniform",
                   lambda gen, shape, device: torch.from_numpy(_prios(shape[1])))

        def j_random_sample(key, gi, num, pos_fraction):
            r = _prios(gi.shape[0])
            return j_sample_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]),
                                        gi > 0, gi == 0, num,
                                        int(num * pos_fraction))

        def j_ohem(gi, losses, num, pos_fraction, key=None):
            seen["jax"] = (gi, losses)  # traced, returned by the jitted call
            return j_ohem_sample(gi, losses, num, pos_fraction)

        def t_ohem(gi, losses, num, pos_fraction):
            seen.update(gi=gi.numpy(), losses=losses.numpy())
            return ohem_sample(gi, losses, num, pos_fraction)

        mp.setattr(jtargets, "random_sample", j_random_sample)
        mp.setattr(jtargets, "ohem_sample", j_ohem)
        mp.setattr(ttargets, "ohem_sample", t_ohem)
        det = JPanopticFuseTrack(train_cfg=_train_cfg(jzoo),
                                 test_cfg=jzoo.tiny_test_cfg(), **_cfg(jzoo))
        jl, (jgi, jlosses) = jax.device_get(jax.jit(lambda p, sample: (
            det.apply({"params": p, "batch_stats": stats}, method=det.loss,
                      rngs={"sampler": jax.random.PRNGKey(0)}, **sample),
            seen["jax"]))(params, {k: jnp.asarray(v) for k, v in s.items()}))
        jl = {k: float(v) for k, v in jl.items()}

        port = PanopticFuseTrack(train_cfg=_train_cfg(zoo),
                                 test_cfg=zoo.fusetrack_test_cfg(),
                                 device="cpu", **_cfg(zoo))
        port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        with torch.no_grad():
            tl = {k: float(v) for k, v in port.loss(
                **{k: torch.from_numpy(v) for k, v in s.items()}).items()}

    # the same candidates, assigned alike; their hard-mining losses within
    # float noise, and the selection's edge wider than that noise
    gi, losses = np.array(jgi), np.array(jlosses)
    np.testing.assert_array_equal(seen["gi"], gi)
    _same_slots(gi, losses, OHEM["num"], OHEM["pos_fraction"])
    scored = gi >= 0
    noise = float(np.abs(seen["losses"] - losses)[scored].max())
    assert noise <= 1e-4 * float(np.abs(losses[scored]).max()) + 1e-6
    margin, n_pos, n_neg = _edge_margin(gi, losses, seen["losses"],
                                        OHEM["num"], OHEM["pos_fraction"])
    assert n_pos >= 1 and n_pos + n_neg > OHEM["num"]
    assert margin > noise, (margin, noise)

    assert set(tl) == set(jl)
    assert jl["loss_cls"] > 0 and jl["loss_mask"] > 0 and jl["loss_match"] > 0
    for k, v in jl.items():
        rel = 1e-4 if k in SELECTION_FREE + ("loss_pano",) else 1e-3
        assert np.isfinite(tl[k])
        assert tl[k] == pytest.approx(v, rel=rel, abs=1e-6), k
