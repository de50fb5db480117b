"""Test-time augmentation through the port's entry point, on the CPU: the
dataset's ``prepare_test_aug`` (the frame and its flip at the test scale and
at a second scale) byte-equal to vps_tpu's on the port's synthetic fixture
(64x128, 1 val video of 2 frames), then ``python -m
vps_torch.tools.test_vpq --aug --aug-scales`` (the tiny model, seeded
random weights through a checkpoint) and ``vps_torch.tools.eval_vpq`` end
to end: an artifact a frame, VPQ in [0, 100], and each frame's outputs
equal to ``predict_aug`` on the packed variants. Last, the loop refuses a
frame whose variants differ from the first frame's.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import os
import os.path as osp
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vps_tpu.data import build_dataset as j_build_dataset

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.data.synth import make_synth_vps
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    random_init_,
)
from vps_torch.tools import eval_vpq, test_vpq
from vps_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128
SCALES = [(W, H), (96, 48)]  # the test scale, then --aug-scales 96x48

CONFIG = """
_base_ = r"{base}"
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
test_cfg = zoo.tiny_test_cfg()
data = dict(test=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
                      ref_prefix=r"{val_img}", nframes_span_test=2,
                      pipeline=dict(img_scale=({W}, {H}))))
"""


def test_test_vpq_aug_end_to_end(tmp_path):
    fix = str(tmp_path / "fixture")
    val_ann, val_img, _ = make_synth_vps(
        fix, mode="val", n_videos=1, n_frames=2, H=H, W=W, seed=1)
    for script, extra in (("create_panoptic_labels.py", ["--workers", "1"]),
                          ("create_panoptic_video_labels.py", [])):
        r = subprocess.run(
            [sys.executable, str(REPO / "prepare_data" / script), "--mode",
             "val", "--root_dir", fix] + extra, capture_output=True,
            text=True, timeout=300, cwd=str(REPO / "prepare_data"))
        assert r.returncode == 0, r.stdout + r.stderr
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(CONFIG.format(
        base=REPO / "vps_torch/configs/cityscapes/fusetrack.py", W=W, H=H,
        val_ann=val_ann, val_img=val_img))
    cfg = Config.fromfile(str(cfg_path))

    # the variants, byte for byte vps_tpu's
    ds = build_dataset(cfg.data["test"])
    jds = j_build_dataset(dict(cfg.data["test"]))
    for idx in range(len(ds)):
        got, meta = ds.prepare_test_aug(idx, flip=True, scales=SCALES)
        want, jmeta = jds.prepare_test_aug(idx, flip=True, scales=SCALES)
        assert meta == jmeta and len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(g[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k

    det = random_init_(build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                                      "cpu"), seed=1)
    ckpt = save_checkpoint(str(tmp_path / "work"), 1, det.state_dict())
    out = str(tmp_path / "out" / "val.pkl")
    gt_json = osp.join(fix, "panoptic_gt_val_city_vps.json")
    summary = test_vpq.main([
        str(cfg_path), "--checkpoint", ckpt, "--out", out, "--aug",
        "--aug-scales", "96x48", "--lambda", "1", "--labeled_fid", "0",
        "--nframes_per_video", "2", "--pan_im_json_file", gt_json,
        "--track_cap", "32", "--device", "cpu"])
    unified = out.replace(".pkl", "_pans_unified")
    assert summary["aug"] and summary["frames"] == 2
    assert sorted(os.listdir(osp.join(unified, "pan_pred"))) == [
        "0001_0000_city.png", "0001_0001_city.png"]

    # each frame's outputs: predict_aug on the packed variants, the track
    # state carried from frame 0 to frame 1
    with open(out.replace(".pkl", "_pano.pkl"), "rb") as f:
        got = pickle.load(f)
    state = empty_track_state(32, device="cpu")
    for idx in range(len(ds)):
        variants, meta = ds.prepare_test_aug(idx, flip=True, scales=SCALES)
        imgs, refs = test_vpq.pack_variants(variants)
        assert imgs.shape == (4, 1, H, W, 3)
        want, state = det.predict_aug(
            torch.from_numpy(imgs), torch.from_numpy(refs), state,
            test_vpq.aug_metas_of(variants),
            img_shape_withoutpad=tuple(meta["img_shape_withoutpad"]))
        nk = int(want["num_keep"])
        np.testing.assert_array_equal(got["all_ssegs"][idx],
                                      want["fcn_outputs"].numpy())
        np.testing.assert_array_equal(got["all_panos"][idx],
                                      want["panoptic_outputs"].numpy())
        np.testing.assert_array_equal(got["all_pano_obj_ids"][idx],
                                      want["panoptic_det_obj_ids"][:nk].numpy())

    final = eval_vpq.main([
        "--submit_dir", unified, "--truth_dir",
        osp.join(fix, "val", "panoptic_video"), "--pan_gt_json_file",
        gt_json, "--nframes_per_video", "2"])
    assert all(0.0 <= v <= 100.0 for v in final)

    # a frame of another raw size changes the variants: refused
    class Mixed:
        pipeline = ds.pipeline

        def __len__(self):
            return 2

        def prepare_test_aug(self, idx, flip, scales):
            variants, meta = ds.prepare_test_aug(idx, flip=flip, scales=scales)
            if idx == 1:
                variants[0] = dict(variants[0], scale_factor=0.5)
            return variants, meta

    args = test_vpq.parse_args([str(cfg_path), "--checkpoint", ckpt, "--out",
                                out, "--aug", "--track_cap", "32"])
    frames = test_vpq._aug_frames(det, Mixed(), args, torch.device("cpu"))
    next(frames)[0]()
    with pytest.raises(ValueError, match="aug meta changed"):
        next(frames)
