"""The control (the reference one precision below the configuration's)
comes out not correct at a test's size: the fp8 conv stacks of the video
cell on the CPU, TF32 of the float32 cells on the card."""

import pytest

import tiny


def _control_fails(name, device="cpu"):
    """(the run's own correct, the numbers the control failed)."""
    rc, res, err = tiny.run_cell(name, seconds=1.0, control=1, device=device)
    assert rc == 0, err
    failed = [k for k, c in res["checks"].items()
              if not res["numbers"][f"control.{k}"] <= c["limit"]]
    return res["correct"], failed


def test_video_fp8_control_fails():
    correct, failed = _control_fails("fusetrack_cs.video")
    assert correct and failed


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fusetrack_cs.train",
                                  "mask_rcnn_coco.images"])
def test_tf32_control_fails_on_the_card(name, card):
    correct, failed = _control_fails(name, device=card)
    assert correct and failed


def test_split_sums_round_otherwise_but_pass():
    """The sound variant that sets the images cell's lower readings: its
    sums round in another order (boxes move), and it stays correct."""
    import traffic
    from reference import drive, judge
    cell = tiny.cell("mask_rcnn_coco.images")
    cfg, t = cell["config_file"], cell["traffic"]
    imgs = traffic.images(t, 5, "cpu")[:1]
    hw = (t["height"], t["width"])
    ref, _ = drive.images(cfg, 5, imgs, hw, "cpu")
    split, _ = drive.images(cfg, 5, imgs, hw, "cpu", control="split")
    nums = judge.images(split, ref)
    assert nums["box_gap"] > 0.0
    assert all(nums[k] <= v for k, v in cell["limits"].items())
