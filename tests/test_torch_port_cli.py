"""The port's three entry points end to end on the CPU, in this process:
``vps_torch.tools.train`` (tiny model, 1 epoch of 2 steps, the validation
hook after it) -> ``vps_torch.tools.test_vpq`` (1 video of 2 frames, its
per-frame loop, ``--chunk 1``) ->
``vps_torch.tools.eval_vpq`` on the port's synthetic fixture at 64x128,
with the eval-side GT built by the repo's prepare_data scripts. Checks the
artifacts, that VPQ lies in [0, 100], and that test_vpq's per-frame outputs
equal ``predict_video`` on the same checkpoint and frames, and that each
tool leaves TF32 off (``f32_policy``). It is the file's only test:
pytest-xdist's loadfile queues files by their number of tests, so it starts
late, off the path of the suite's longest file.
"""

import json
import os
import os.path as osp
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_numerics import _set_tf32, _tf32_off, tf32_on  # noqa: F401
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.data.synth import make_synth_vps
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    predict_video,
)
from vps_torch.tools import eval_vpq, test_vpq, train
from vps_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128

CONFIG = """
_base_ = r"{base}"
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()
_pipe = dict(img_scale=({W}, {H}), ratio_range=(1.0, 1.0), flip_ratio=0.5,
             crop_size=({H}, {W}), max_gt=8)
_test = dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
             ref_prefix=r"{val_img}", nframes_span_test=2,
             pipeline=dict(img_scale=({W}, {H})))
data = dict(
    workers_per_gpu=0,
    train=dict(times=1, dataset=dict(
        ann_file=r"{train_ann}", img_prefix=r"{train_img}",
        ref_prefix=r"{train_img}", seg_prefix=r"{train_seg}",
        ref_ann_file=r"{train_ann}", pipeline=_pipe)),
    val=_test,
    test=_test,
)
evaluation = dict(interval=1)
lr_config = dict(warmup_iters=2, step=[8])
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
total_epochs = 1
"""


def test_train_test_vpq_eval_vpq(tmp_path, tf32_on, capsys):
    fix = str(tmp_path / "fixture")
    train_ann, train_img, train_seg = make_synth_vps(
        fix, mode="train", n_videos=1, n_frames=2, H=H, W=W, seed=0,
        first_video=101)
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
        train_ann=train_ann, train_img=train_img, train_seg=train_seg,
        val_ann=val_ann, val_img=val_img))
    work = str(tmp_path / "work")

    runner = train.main([str(cfg_path), "--work_dir", work, "--device", "cpu"])
    assert _tf32_off()
    hist = runner.log_history
    assert [r["iter"] for r in hist] == [1, 2]
    for rec in hist:
        assert np.isfinite(rec["loss"]) and rec["nonfinite_skips"] == 0
    ckpt = latest_checkpoint(work)
    assert ckpt.endswith("ckpt_2.pth")
    assert "Eval [1] eval_det_frac" in Path(work, "train.log").read_text()

    _set_tf32()
    out = str(tmp_path / "out" / "val.pkl")
    gt_json = osp.join(fix, "panoptic_gt_val_city_vps.json")
    summary = test_vpq.main([
        str(cfg_path), "--checkpoint", ckpt, "--out", out, "--preset",
        "exact", "--lambda", "1", "--labeled_fid", "0",
        "--nframes_per_video", "2", "--pan_im_json_file", gt_json,
        "--track_cap", "32", "--chunk", "1", "--device", "cpu"])
    assert _tf32_off()
    unified = out.replace(".pkl", "_pans_unified")
    pngs = sorted(os.listdir(osp.join(unified, "pan_pred")))
    assert pngs == ["0001_0000_city.png", "0001_0001_city.png"]
    assert summary["frames"] == 2 and len(summary["steady_s"]) == 1
    with open(osp.join(unified, "pred.json")) as f:
        assert len(json.load(f)["annotations"]) == 2

    # the same checkpoint and frames through predict_video
    cfg = Config.fromfile(str(cfg_path))
    from vps_torch import zoo
    det = build_detector(zoo.preset_overrides(cfg.model, "exact"),
                         cfg.train_cfg, cfg.test_cfg, "cpu")
    det.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    ds = build_dataset(cfg.data["test"])
    (a, _, meta), (b, _, _) = ds.prepare_test(0), ds.prepare_test(1)
    imgs = torch.from_numpy(np.stack([a, b]))[:, None]
    want, _ = predict_video(det, imgs, [True, False],
                            empty_track_state(32, device="cpu"), imgs[0],
                            img_shape_withoutpad=meta["img_shape_withoutpad"])
    with open(out.replace(".pkl", "_pano.pkl"), "rb") as f:
        got = pickle.load(f)
    for t in range(2):
        nk = int(want["num_keep"][t])
        np.testing.assert_array_equal(got["all_ssegs"][t],
                                      want["fcn_outputs"][t].numpy())
        np.testing.assert_array_equal(got["all_panos"][t],
                                      want["panoptic_outputs"][t].numpy())
        np.testing.assert_array_equal(got["all_pano_cls_inds"][t],
                                      want["panoptic_cls_inds"][t, :nk].numpy())
        np.testing.assert_array_equal(
            got["all_pano_obj_ids"][t],
            want["panoptic_det_obj_ids"][t, :nk].numpy())

    _set_tf32()
    final = eval_vpq.main([
        "--submit_dir", unified, "--truth_dir",
        osp.join(fix, "val", "panoptic_video"), "--pan_gt_json_file",
        gt_json, "--nframes_per_video", "2"])
    assert _tf32_off()
    assert all(0.0 <= v <= 100.0 for v in final)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("vpq_all")][-1]
    assert float(line.split()[1]) == pytest.approx(final[0], abs=1e-4)
    for k in ("0", "5", "10", "15", "final"):
        assert osp.exists(osp.join(unified, f"vpq-{k}.txt"))
