"""Port parity, the R-CNN zoo's two-stage detectors: vps_torch's
FasterRCNN, MaskRCNN, FastRCNN (the precomputed proposals of
tests/test_two_stage.py) and RPN held against vps_tpu's ``predict`` on the
tiny configs and 64x64 image of tests/test_two_stage.py, seeded weights
(``tests/zoo_parity.py``: its bar); and ``paste_masks`` on Mask R-CNN's
mask logits at the image's size.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.ops.mask import paste_masks as j_paste_masks

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import tiny_cfg
from zoo_parity import BOX_TOL, MASK, assert_dets_match, pair

from vps_torch.models.detectors import FasterRCNN, MaskRCNN, RPN
from vps_torch.ops.mask import paste_masks


def test_faster_mask_fast_rcnn_rpn_and_paste():
    want, got, port = pair("FasterRCNN", tiny_cfg())
    assert type(port) is FasterRCNN and "mask_logits" not in got
    assert_dets_match(want, got)

    want, got, port = pair("MaskRCNN", tiny_cfg(**MASK), seed=1)
    assert type(port) is MaskRCNN and got["mask_logits"].shape == (6, 28, 28)
    assert_dets_match(want, got)
    # the masks a user gets: pasted at the image's size, then binarised
    boxes, logits = want["det_bboxes"][:, :4], want["mask_logits"]
    for binarize in (None, 0.0):
        jp = jax.jit(lambda m, b: j_paste_masks(m, b, (64, 64), binarize))(
            jnp.asarray(logits), jnp.asarray(boxes))
        pp = paste_masks(torch.from_numpy(np.array(logits)),
                         torch.from_numpy(np.array(boxes)),
                         (64, 64), binarize)
        assert pp.shape == (6, 64, 64)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
    assert 0 < float(pp.mean()) < 1

    props = np.asarray([[2.0, 2.0, 30.0, 32.0], [28.0, 6.0, 62.0, 42.0],
                        [8.0, 30.0, 44.0, 62.0], [0.0, 0.0, 16.0, 16.0]] * 4,
                       np.float32)
    pvalid = np.arange(16) < 14
    cfg = {k: v for k, v in tiny_cfg().items() if k != "rpn_head"}
    want, got, port = pair("FastRCNN", cfg, seed=2, proposals=(props, pvalid))
    assert port.rpn_head is None
    assert_dets_match(want, got)

    base = tiny_cfg()
    cfg = {k: base[k] for k in ("backbone", "neck", "rpn_head")}
    want, got, port = pair("RPN", cfg, seed=3)
    assert type(port) is RPN and set(got) == set(want) == {
        "proposals", "scores", "proposal_valid"}
    assert got["proposals"].shape == (8, 4) and want["proposal_valid"].all()
    np.testing.assert_array_equal(got["proposal_valid"], want["proposal_valid"])
    np.testing.assert_allclose(got["proposals"], want["proposals"], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=BOX_TOL)
