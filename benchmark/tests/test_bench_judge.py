"""The comparison's own arithmetic: one-to-one pairs of detections, and
instances and track ids of the program against the replay."""

import numpy as np

from reference import judge


def test_pairs_are_one_to_one():
    # two program boxes on one reference box: one pair, not two
    a = np.array([[0, 0, 9, 9], [0, 0, 9, 9]], np.float32)
    b = np.array([[0, 0, 9, 9]], np.float32)
    lab = np.array([1, 1])
    assert judge._pairs(a, lab, b, lab[:1], 0.9) == [(0, 0)]
    assert judge._pairs(a, lab, b, np.array([2]), 0.9) == []


def _frame(pan, cls, obj_ids):
    return {"panoptic_outputs": pan, "num_keep": np.array([len(cls)]),
            "panoptic_cls_inds": np.array(cls),
            "panoptic_det_obj_ids": np.array(obj_ids),
            "fcn_outputs": np.zeros_like(pan),
            "det_bboxes": np.zeros((1, 4), np.float32),
            "det_labels": np.zeros(1, np.int64),
            "det_valid": np.zeros(1, bool)}


def test_instances_and_tracks_against_the_replay():
    pan = np.full((4, 4), 11)  # one instance (num_stuff 11) over the map
    half = pan.copy()
    half[:2] = 0  # half of it stuff
    prog = [_frame(pan, [1], [0]), _frame(pan, [1], [1])]  # a new id: lost
    rep = [_frame(pan, [1], [0]), _frame(pan, [1], [0])]  # tracked
    nums = judge.video(prog, prog, rep, num_stuff=11)
    assert nums["track_disagree"] == 1.0
    assert nums["fusion_unmatched"] == 0.0
    assert nums["sem_disagree"] == 0.0
    # the replay keeps the instance on half the pixels: IoU 0.5 still pairs
    assert judge.video(prog, prog, [rep[0], _frame(half, [1], [0])],
                       11)["fusion_unmatched"] == 0.0
    # another class: nothing pairs
    nums = judge.video(prog, prog, [rep[0], _frame(pan, [2], [0])], 11)
    assert nums["fusion_unmatched"] == 0.5
