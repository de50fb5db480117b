"""Shared pieces of the guided-anchoring parity tests
(``tests/test_torch_port_ga_*.py``): tests/test_ga_reppoints.py's tiny heads
(``GA_KW``: 3 levels of 32 channels at strides 8-32, 2 deformable groups)
and features, seeded JAX variables (``jax.eval_shape`` of ``init``, filled
by ``zoo_parity.fill``; no ``init`` is run), the port's head loaded through
``state_dict_from_jax`` with ``strict=True``, overlapping and padded gt,
and ``train_pair``: both stacks' GA loss on the same weights, features,
gt and sampler draws, with every assignment and sampled set recorded, for
``zoo_parity.assert_train_match``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vps_tpu.core.targets as jtargets
import vps_tpu.models.ga_heads as jga
from vps_tpu.core.sampler import _sample_by_priority as j_by_priority

from test_ga_reppoints import CFG, GA_KW, _feats
from zoo_parity import Draws, fill

import vps_torch.core.sampler as tsampler
import vps_torch.core.targets as ttargets
import vps_torch.models.ga_heads as tga
from vps_torch.convert import state_dict_from_jax

IMG_SHAPE = (128, 256)
# three valid gt of four, the second and third overlapping, the last padding
GT = dict(gt_bboxes=np.asarray([[8, 8, 120, 100], [40, 20, 90, 60],
                                [44, 24, 100, 70], [0, 0, 0, 0]], np.float32),
          gt_labels=np.asarray([2, 3, 1, 0], np.int32),
          gt_valid=np.asarray([True, True, True, False]))
# test_ga_reppoints' train settings, with mmdet's ga_sampler (a random
# sampler) and, for GA-RPN, the RPN's assigner, sampler and border
GA_CFG = dict(CFG, ga_sampler=dict(num=64, pos_fraction=0.5))
RPN_CFG = dict(GA_CFG, assigner=dict(pos_iou_thr=0.7, neg_iou_thr=0.3,
                                     min_pos_iou=0.3),
               sampler=dict(num=64, pos_fraction=0.5), allowed_border=0)
HEADS = {"GuidedAnchorHead": dict(num_classes=5),
         "GARPNHead": {},
         "GARetinaHead": dict(num_classes=5, stacked_convs=2)}


def features():
    """test_ga_reppoints' seeded levels, (1, H, W, 32) numpy."""
    return [np.asarray(f) for f in _feats()]


def port_feats(feats):
    return [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]


def head_pair(kind, seed=0, **over):
    """vps_tpu's ``kind`` head, its seeded variables, and the port's head on
    the CPU loaded from them (strict)."""
    kw = dict(HEADS[kind], **GA_KW, **over)
    jhead = getattr(jga, kind)(**kw)
    feats = [jnp.asarray(f) for f in features()]
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), feats))
    rng = np.random.default_rng(seed)
    variables = {k: fill(v, rng) for k, v in shapes.items()}
    port = getattr(tga, kind)(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"]),
                         strict=True)
    return jhead, variables, port


def _record(mp, module, name, pick, out):
    """Wraps ``module.name`` so that each call appends ``pick`` of its
    result to ``out`` (on the JAX side a traced value, returned by the
    jitted function: a host callback would keep its executable out of the
    persistent compile cache)."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(pick(res))
        return res

    mp.setattr(module, name, wrapped)


def train_pair(kind, seed=0):
    """vps_tpu's and the port's GA loss (``ga_rpn_loss`` for GARPNHead, with
    RPN_CFG; else ``ga_loss`` with GA_CFG) of the head's outputs on
    ``features()`` and GT, the same seeded weights and the same sampler
    draws (``Draws``). JAX's side is one jitted value_and_grad of the sum
    of the terms. Returns zoo_parity.train_pair's dict: ``jl`` / ``tl`` the
    terms, ``jg`` / ``tg`` the gradients by the port's names, ``jsel`` /
    ``tsel`` each sampled set (inds, valid) then each assignment
    (assigned_gt_inds, all valid), in call order."""
    rpn = kind == "GARPNHead"
    jhead, variables, port = head_pair(kind, seed)
    feats = [jnp.asarray(f) for f in features()]
    gt = {k: jnp.asarray(v) for k, v in GT.items()}
    jdraws, tdraws = Draws(seed), Draws(seed)
    jsample, jassign = [], []

    def j_random_sample(key, gi, num, pos_fraction):
        r = jdraws(gi.shape[0])
        res = j_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]), gi > 0,
                            gi == 0, num, int(num * pos_fraction))
        jsample.append((res.inds, res.valid))
        return res

    def assigned(res):
        return res.assigned_gt_inds

    def f(p):
        outs = jhead.apply({"params": p}, feats)
        if rpn:
            losses = jga.ga_rpn_loss(jax.random.PRNGKey(1), jhead, *outs,
                                     gt["gt_bboxes"], gt["gt_valid"],
                                     IMG_SHAPE, RPN_CFG)
        else:
            losses = jga.ga_loss(jax.random.PRNGKey(1), jhead, *outs,
                                 gt["gt_bboxes"], gt["gt_labels"],
                                 gt["gt_valid"], IMG_SHAPE, GA_CFG)
        return sum(losses.values()), (losses, list(jsample), list(jassign))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jga, "random_sample", j_random_sample)
        mp.setattr(jtargets, "random_sample", j_random_sample)
        _record(mp, jga, "approx_max_iou_assign", assigned, jassign)
        _record(mp, jtargets if rpn else jga, "max_iou_assign", assigned,
                jassign)
        (_, (jl, jsample, jassign)), jg = jax.jit(
            jax.value_and_grad(f, has_aux=True))(variables["params"])
        jl = {k: float(v) for k, v in jl.items()}
        jsample = [(np.asarray(i), np.asarray(v)) for i, v in jsample]
        jassign = [np.asarray(a) for a in jassign]

    tsample, tassign = [], []
    tgt = {k: torch.from_numpy(v) for k, v in GT.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsampler, "uniform", lambda gen, shape, device:
                   torch.from_numpy(tdraws(shape[1])))
        for mod in (tga, ttargets):
            fn = mod.random_sample

            def recording(gen, gi, num, pos_fraction, _fn=fn):
                res = _fn(gen, gi, num, pos_fraction)
                tsample.append((res.inds.numpy(), res.valid.numpy()))
                return res

            mp.setattr(mod, "random_sample", recording)
        _record(mp, tga, "approx_max_iou_assign", assigned, tassign)
        _record(mp, ttargets if rpn else tga, "max_iou_assign", assigned,
                tassign)
        outs = port(port_feats(features()))
        if rpn:
            losses = tga.ga_rpn_loss(None, port, *outs, tgt["gt_bboxes"],
                                     tgt["gt_valid"], IMG_SHAPE, RPN_CFG)
        else:
            losses = tga.ga_loss(None, port, *outs, tgt["gt_bboxes"],
                                 tgt["gt_labels"], tgt["gt_valid"],
                                 IMG_SHAPE, GA_CFG)
        sum(losses.values()).backward()

    def all_valid(sel):
        return [(np.asarray(a, np.int64), np.ones(a.shape, bool))
                for a in sel]

    return dict(jl=jl, tl={k: float(v.detach()) for k, v in losses.items()},
                jg={k: v.numpy() for k, v in state_dict_from_jax(
                    jax.tree.map(np.asarray, jg)).items()},
                tg={n: None if p.grad is None else p.grad.numpy()
                    for n, p in port.named_parameters()},
                jsel=jsample + all_valid(jassign),
                tsel=tsample + all_valid([a.numpy() for a in tassign]),
                port=port)


# the masked forward's loc threshold: about half the positions filtered
MASK_THR = 0.5


def assert_forward_match(kind):
    """``kind``'s forward on features(), unmasked and masked (loc filter at
    MASK_THR), against JAX's (one jitted apply of both): every output within
    atol 1e-5, rtol 1e-4; masked, positions whose JAX sigmoid(loc) lies
    within 1e-6 of the threshold (at most 0.1% of them) are left out, the
    rest have the same mask and the filtered ones are exactly 0 on both
    sides."""
    jhead, variables, port = head_pair(kind, loc_filter_thr=MASK_THR)
    feats = [jnp.asarray(f) for f in features()]
    want = jax.jit(lambda v: (jhead.apply(v, feats),
                              jhead.apply(v, feats, masked=True)))(variables)
    with torch.no_grad():
        got = (port(port_feats(features())),
               port(port_feats(features()), masked=True))
    want = jax.tree.map(np.asarray, want)
    got = [[[t.numpy() for t in lvls] for lvls in outs] for outs in got]
    for w_lvls, g_lvls in zip(want[0], got[0]):
        for w, g in zip(w_lvls, g_lvls):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    kept = near = total = 0
    for lvl, loc in enumerate(want[0][3]):
        sig = np.asarray(jax.nn.sigmoid(loc[..., 0]))
        close = np.abs(sig - MASK_THR) <= 1e-6
        mask = sig >= MASK_THR
        near += int(close.sum())
        total += close.size
        kept += int((mask & ~close).sum())
        # the port's own loc gives the same mask away from the threshold
        port_mask = 1 / (1 + np.exp(-got[0][3][lvl][..., 0])) >= MASK_THR
        np.testing.assert_array_equal(port_mask[~close], mask[~close])
        for out in (0, 1):  # cls, reg
            w, g = want[1][out][lvl], got[1][out][lvl]
            far = ~close
            assert (w[far & ~mask] == 0).all() and (g[far & ~mask] == 0).all()
            np.testing.assert_allclose(g[far & mask], w[far & mask],
                                       rtol=1e-4, atol=1e-5)
    assert near <= 1e-3 * total, (near, total)
    assert 0.1 * total < kept < 0.9 * total, (kept, total)
