"""A run with the timed path broken underneath comes out not correct:
the whole harness at the tiny size on the CPU, its look for a card
skipped, once for each fault the cell can have, and once sound."""

import pytest

import tiny


def _answer_altered_video():
    from vps_torch.models.detectors.panoptic import PanopticFuseTrack
    outputs = PanopticFuseTrack._outputs

    def altered(*args, **kw):
        out = outputs(*args, **kw)
        out["fcn_outputs"] = (out["fcn_outputs"] + 1) % 19
        return out
    return PanopticFuseTrack, "_outputs", staticmethod(altered)


def _carry_unchanged_video():
    from vps_torch.models.detectors import panoptic
    predict_video = panoptic.predict_video

    def unchanged(det, imgs, resets, state, prev_img, prev_feats=None, **kw):
        out, _ = predict_video(det, imgs, resets, state, prev_img,
                               prev_feats=prev_feats, **kw)
        return out, (state, prev_feats, prev_img)
    return panoptic, "predict_video", unchanged


def _fusion_altered_video():
    from vps_torch.models.detectors import panoptic
    fuse = panoptic.mask_removal_and_fuse

    def altered(boxes, probs, cls, valid, ids, masks, *args, **kw):
        return fuse(boxes, probs, cls, valid, ids, masks + 4.0, *args, **kw)
    return panoptic, "mask_removal_and_fuse", altered


def _state_unchanged_train():
    from vps_torch.train.optim import Optimizer

    def step(self):
        self.zero_grad()
        return True
    return Optimizer, "step", step


def _answer_altered_images():
    from vps_torch.models.detectors import MaskRCNN
    predict = MaskRCNN.predict

    def altered(self, img, *args):
        out = predict(self, img, *args)
        out["det_bboxes"] = out["det_bboxes"] + 8.0
        return out
    return MaskRCNN, "predict", altered


@pytest.mark.parametrize("name,fault", [
    ("fusetrack_cs.video", None),
    ("fusetrack_cs.video", _answer_altered_video),
    ("fusetrack_cs.video", _carry_unchanged_video),
    ("fusetrack_cs.train", None),
    ("fusetrack_cs.train", _state_unchanged_train),
    ("mask_rcnn_coco.images", None),
    ("mask_rcnn_coco.images", _answer_altered_images),
])
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    if fault is not None:
        monkeypatch.setattr(*fault())
    rc, res, err = tiny.run_cell(name, seconds=1.0)
    assert rc == 0, err
    assert res["correct"] is (fault is None), res["checks"]


def test_fusion_fault_shows_in_the_reported_numbers(monkeypatch):
    """The fusion's output is reported, not compared (sound runs and the
    fp8 control overlap on it at the cell's size): a fault planted there
    reads far above a sound run, and ``correct`` does not see it."""
    monkeypatch.setattr(*_fusion_altered_video())
    rc, res, err = tiny.run_cell("fusetrack_cs.video", seconds=1.0)
    assert rc == 0, err
    assert "fusion_unmatched" not in res["checks"]
    assert res["numbers"]["fusion_unmatched"] > 0.1
