"""Port parity, guided anchoring's decode: vps_torch's ``ga_bboxes`` and
``ga_rpn_proposals`` against vps_tpu's on the same seeded per-level maps
(3 levels at strides 8-32, GA-RPN's anchoring and target stds), the loc
filter on at a threshold that filters most locations, so that each
level's ``top_k`` picks among many scores of exactly 0 (ties in index
order on both sides). Detections under ``zoo_parity.assert_dets_match``'s
bar; proposals and scores within 1e-4, validity equal.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import vps_tpu.models.ga_heads as jga

import vps_torch.models.ga_heads as tga
from ga_parity import GA_KW, IMG_SHAPE
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import assert_dets_match

SIZES = [(16, 32), (8, 16), (4, 8)]
THR = 0.8  # sigmoid of a N(0, 1) loc logit: about 9% of locations kept
KW = dict(GA_KW, loc_filter_thr=THR,
          anchoring_stds=(0.07, 0.07, 0.14, 0.14),
          target_stds=(0.07, 0.07, 0.11, 0.11))


def _maps(fg, seed):
    rng = np.random.RandomState(seed)
    return [[rng.normal(scale=s, size=(1, h, w, c)).astype(np.float32)
             for h, w in SIZES]
            for c, s in ((fg, 2.0), (4, 0.5), (2, 0.5), (1, 1.0))]


def _run(jfn, tfn, jhead, thead, maps, **kw):
    want = jax.jit(lambda m: jfn(jhead, *m, IMG_SHAPE, **kw))(
        jax.tree.map(jnp.asarray, maps))
    got = tfn(thead, *[[torch.from_numpy(x) for x in lvls] for lvls in maps],
              IMG_SHAPE, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_ga_decode_with_the_loc_filter_matches_jax():
    jhead = jga.GuidedAnchorHead(num_classes=5, **KW)
    thead = tga.GuidedAnchorHead(num_classes=5, **KW, device="cpu")
    maps = _maps(4, 0)
    kept = sum(float((1 / (1 + np.exp(-lp)) >= THR).mean()) for lp in maps[3])
    assert kept < 0.5 * len(SIZES)  # most locations filtered
    want, got = _run(jga.ga_bboxes, tga.ga_bboxes, jhead, thead, maps,
                     nms_pre=200, score_thr=0.05, max_per_img=30)
    names = ("det_bboxes", "det_labels", "det_valid")
    assert_dets_match(dict(zip(names, want)), dict(zip(names, got)))

    jhead = jga.GARPNHead(**KW)
    thead = tga.GARPNHead(**KW, device="cpu")
    maps = _maps(1, 1)
    want, got = _run(jga.ga_rpn_proposals, tga.ga_rpn_proposals, jhead,
                     thead, maps, nms_pre=200, max_num=300,
                     min_bbox_size=2.0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    # proposals of filtered locations (score 0) were chosen among ties
    assert (want[1][want[2]] == 0).sum() > 10 and want[2].sum() > 50
