"""``vps_torch.tools.test_vpq`` streamed (``--chunk 2 --streams 2
--show_dir``) against its per-frame loop (``--chunk 1``) on the CPU, on a
72x128 VIPER-format fixture (``viper_fixture.py``) of 3 val videos of 3
frames, with the tiny model of the port's VIPER config and a seeded
checkpoint. Videos go to the streams in turn (0, 1, 0), each video's third
frame ends a chunk padded with it, and the streams are recorded stream by
stream, so the outputs reach the tool out of the dataset's order: the
pickle, the unified PNGs and ``pred.json`` must still equal the per-frame
loop's, byte for byte, with the maps brought back from the network's
114x64 to the frame's 72x128. Each ``--show_dir`` image must be byte-equal
to vps_tpu's drawing (``vps_tpu.utils.visualize``, as the repo tool's
``show_frame`` draws) of the same frame's ``predict_video`` outputs. The
tool runs under ``inference_policy`` and gives cuDNN's flags back.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import os
import pickle
from pathlib import Path

import cv2
import numpy as np
import torch

from vps_tpu.utils.visualize import draw_detections, panoptic_to_color

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from viper_fixture import make_viper_fixture

from vps_torch import zoo
from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    predict_video,
    random_init_,
)
from vps_torch.tools import test_vpq
from vps_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
H, W = 72, 128
VIDEOS, FRAMES = 3, 3

CONFIG = """
_base_ = r"{base}"
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
model["panoptic"].update(num_things_classes=10, num_classes=23)
model["bbox_head"]["num_classes"] = 11
model["mask_head"]["num_classes"] = 11
test_cfg = zoo.tiny_test_cfg()
test_cfg["panoptic"].update(score_thresh=0.2, max_det=12)
test_cfg["class_mapping"] = {{i: i + 12 for i in range(1, 11)}}
data = dict(test=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
                      ref_prefix=r"{val_img}", nframes_span_test={frames},
                      pipeline=dict(img_scale=({w}, 64))))
"""


def _files(root):
    """{relative path: bytes} of every file under root."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_streams_equal_the_per_frame_loop(tmp_path):
    fix = make_viper_fixture(str(tmp_path / "viper_vps"), train_frames=2,
                             val_videos=VIDEOS, val_frames=FRAMES, h=H, w=W)
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(CONFIG.format(
        base=REPO / "vps_torch/configs/viper/fusetrack.py", w=W,
        frames=FRAMES, val_ann=fix["val_ann"], val_img=fix["val_img"]))
    cfg = Config.fromfile(str(cfg_path))
    model = zoo.preset_overrides(cfg.model, "exact")
    det = random_init_(build_detector(model, cfg.train_cfg, cfg.test_cfg,
                                      "cpu"), seed=3)
    with torch.no_grad():  # a milder classifier: probabilities that do not
        det.bbox_head.fc_cls.weight.mul_(0.25)  # saturate and tie
    ckpt = save_checkpoint(str(tmp_path / "work"), 0, det.state_dict())

    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.benchmark = True
    common = [str(cfg_path), "--checkpoint", ckpt, "--preset", "exact",
              "--lambda", "1", "--labeled_fid", "0", "--nframes_per_video",
              str(FRAMES), "--pan_im_json_file", fix["gt_json"],
              "--track_cap", "32", "--device", "cpu"]
    show = tmp_path / "show"
    try:
        one = test_vpq.main(common + ["--out", str(tmp_path / "one" / "v.pkl"),
                                      "--chunk", "1"])
        assert not one["streamed"] and len(one["steady_s"]) == 6
        many = test_vpq.main(common + [
            "--out", str(tmp_path / "many" / "v.pkl"), "--chunk", "2",
            "--streams", "2", "--show_dir", str(show), "--mode", "test",
            "--n_video", "5"])
        assert many["streamed"] and one["numerics"] == many["numerics"]
        assert many["numerics"]["cudnn.deterministic"] is True
        assert many["numerics"]["cudnn.benchmark"] is False
        assert torch.backends.cudnn.benchmark is True  # given back
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old

    # the maps at the frame's size, not at the network's 114x64
    with open(one["pickle"], "rb") as f:
        maps = pickle.load(f)
    assert {m.shape for m in maps["all_ssegs"] + maps["all_panos"]} == {(H, W)}
    a, b = _files(tmp_path / "one"), _files(tmp_path / "many")
    assert sorted(a) == sorted(b)
    assert len([k for k in a if k.endswith(".png")]) == VIDEOS * FRAMES
    for k in a:
        assert a[k] == b[k], k

    # the show_dir images against vps_tpu's drawing of predict_video's
    # outputs, video by video
    ds = build_dataset(cfg.data["test"])
    shape = tuple(ds.prepare_test(0)[2]["img_shape_withoutpad"])
    assert sorted(os.listdir(show)) == sorted(
        im["file_name"].replace(".jpg", ".png") for im in ds.img_infos)
    dets = 0
    for v in range(VIDEOS):
        frames = [ds.prepare_test(v * FRAMES + t) for t in range(FRAMES)]
        imgs = torch.from_numpy(np.stack([f[0] for f in frames]))[:, None]
        out, _ = predict_video(det, imgs, [True] + [False] * (FRAMES - 1),
                               empty_track_state(32, device="cpu"), imgs[0],
                               img_shape_withoutpad=shape)
        for t, (_, _, meta) in enumerate(frames):
            o = {k: x[t].numpy() for k, x in out.items()}
            raw = cv2.imread(os.path.join(ds.img_prefix, meta["filename"]))
            frame = cv2.resize(raw, (shape[1], shape[0]))[..., ::-1]
            valid = o["det_valid"].astype(bool)
            dets += int(valid.sum())
            drawn = draw_detections(
                frame, np.concatenate([o["det_bboxes"][valid],
                                       o["det_probs"][valid, None]], -1),
                o["det_labels"][valid], class_names=ds.CLASSES)
            pan = cv2.resize(panoptic_to_color(
                o["panoptic_outputs"].astype(np.int64), divisor=1),
                (shape[1], shape[0]), interpolation=cv2.INTER_NEAREST)
            name = meta["filename"].replace(".jpg", ".png")
            want = tmp_path / "want.png"
            cv2.imwrite(str(want), np.concatenate([drawn, pan], 1)[..., ::-1])
            assert (show / name).read_bytes() == want.read_bytes(), name
    assert dets > 0
