"""Port parity, the R-CNN zoo's NMS: vps_torch's ``multiclass_nms`` (with
``nms`` and with ``soft_nms``, linear and gaussian), ``batched_nms`` and
``soft_nms`` held against vps_tpu's on seeded boxes that overlap in chains
and carry exact ties (duplicate boxes, equal scores within and across
classes), and the batched fixpoint's host syncs: one loop for every class,
as many syncs as the longest chain of any class, the same for 5 classes as
for 81.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import importlib

import numpy as np
import jax
import torch

from vps_tpu.ops.nms import batched_nms as j_batched_nms
from vps_tpu.ops.nms import multiclass_nms as j_multiclass_nms
from vps_tpu.ops.nms import nms as j_nms
from vps_tpu.ops.nms import soft_nms as j_soft_nms

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.ops.nms import batched_nms, multiclass_nms, nms, soft_nms

# the module (vps_torch.ops exports the function under the same name)
nms_mod = importlib.import_module("vps_torch.ops.nms")

T = torch.from_numpy


def _boxes(rng, n):
    """n boxes in chains of overlapping neighbours, with exact duplicates."""
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(8, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    chain = np.arange(0, n // 3)
    boxes[chain] = boxes[0] + np.float32(2.5) * chain[:, None]  # a long chain
    boxes[n - 4:n - 2] = boxes[3]  # duplicates of a chained box
    return boxes


def _scores(rng, n, k):
    """Softmax-like scores over k classes (0 = background) with ties: two
    pairs of proposals equal in every class (one pair the duplicate boxes,
    which overlap, so the tie decides which survives), and equal scores
    across classes."""
    s = rng.dirichlet(np.full(k, 0.4), n).astype(np.float32)
    s[5] = s[4]
    s[:, 2] = np.where(np.arange(n) % 4 == 0, s[:, 1], s[:, 2])
    s[n - 4] = s[n - 3] = np.linspace(0.9, 0.1, k)  # high: among the dets
    return s


def _syncs(fn):
    before = nms_mod.fixpoint_syncs
    out = fn()
    return out, nms_mod.fixpoint_syncs - before


def test_multiclass_nms_soft_nms_batched_nms_and_syncs():
    rng = np.random.RandomState(11)
    n, k = 48, 5
    boxes = _boxes(rng, n)
    spec = (boxes[:, None, :] + rng.uniform(-2, 2, (n, k, 4))).reshape(n, 4 * k)
    spec = spec.astype(np.float32)
    scores = _scores(rng, n, k)
    cfgs = [dict(type="nms", iou_thr=0.5),
            dict(type="soft_nms", iou_thr=0.3, min_score=0.05),
            dict(type="soft_nms", iou_thr=0.3, min_score=0.05,
                 method="gaussian", sigma=0.5)]
    for cfg in cfgs:
        for bx in (boxes, spec):  # class-agnostic and class-specific boxes
            want = jax.jit(lambda b, s: j_multiclass_nms(
                b, s, 0.05, 0.5, 20, nms_cfg=cfg))(bx, scores)
            got = multiclass_nms(T(bx), T(scores), 0.05, 0.5, 20, nms_cfg=cfg)
            what = f"{cfg} {bx.shape}"
            valid = np.asarray(want[2])
            assert valid.sum() >= 8, what
            np.testing.assert_array_equal(got[2].numpy(), valid, err_msg=what)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                          err_msg=what)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=0, atol=1e-5, err_msg=what)

    # the soft-NMS step alone: decayed scores and keep set
    sv = scores[:, 1] > 0.05
    for method in ("linear", "gaussian"):
        ws, wk = jax.jit(lambda b, s, v: j_soft_nms(
            b, s, 0.3, 0.5, 0.05, method, valid=v))(boxes, scores[:, 1], sv)
        gs, gk = soft_nms(T(boxes), T(scores[:, 1]), 0.3, 0.5, 0.05, method,
                          valid=T(sv))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)

    # batched_nms and single nms, with ties, keep sets identical
    idxs = rng.randint(0, 3, n).astype(np.int32)
    flat = scores[:, 1].copy()
    flat[7] = flat[6]
    want = jax.jit(lambda b, s, i: j_batched_nms(b, s, i, 0.5))(boxes, flat, idxs)
    np.testing.assert_array_equal(
        batched_nms(T(boxes), T(flat), T(idxs), 0.5).numpy(), np.asarray(want))
    want = jax.jit(lambda b, s: j_nms(b, s, 0.3))(boxes, flat)
    keep, single = _syncs(lambda: nms(T(boxes), T(flat), 0.3))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert not keep.numpy().all() and single > 2  # real suppression chains

    # one fixpoint for all classes: syncs = the longest chain of any class
    # (each class alone, + 1 to see the fixpoint), the same with 5 classes
    # and with the 5 tiled to 81
    per_class = [_syncs(lambda: nms(T(boxes), T(scores[:, c]), 0.5,
                                    valid=T(scores[:, c] > 0.05)))[1]
                 for c in range(1, k)]
    _, five = _syncs(lambda: multiclass_nms(T(boxes), T(scores), 0.05, 0.5,
                                            20))
    wide = np.concatenate([scores[:, :1]] + [scores[:, 1:]] * 20, 1)
    assert wide.shape == (n, 81)
    _, eighty_one = _syncs(lambda: multiclass_nms(T(boxes), T(wide), 0.05, 0.5,
                                                  20))
    assert five == max(per_class) == eighty_one, (five, per_class, eighty_one)
    assert sum(per_class) > five
