"""Port parity, the corruption benchmark: ``vps_torch.tools.test_robustness
--device cpu`` on the tiny FuseTrack (seeded weights, saved as the port's
checkpoint) over a 2-frame 64x128 synthetic video, tested at 48x96 (scale
factor 0.75), clean and under gaussian_noise and fog at severity 1. Each
run's detections equal, exactly, the port's own ``predict`` on the frames
corrupted by vps_tpu's ``corrupt`` (renormalised here, the image seeded
with its index and the reference frame with index + 10000), and each run's
bbox_mAP equals vps_tpu's ``eval_map`` over them; robustness_eval on the
report equals the repo tool's ``aggregate``. No JAX model is built.

The file's only test: pytest-xdist's loadfile queues files by their number
of tests, so it starts late, off the path of the suite's longest file.
"""

import json

import numpy as np
import torch

from vps_tpu.data.corruptions import corrupt as j_corrupt
from vps_tpu.eval.mean_ap import eval_map as j_eval_map

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from repo_tools import tool
from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.data.synth import make_synth_vps
from vps_torch.data.transforms import IMG_MEAN, IMG_STD
from vps_torch.models.builder import build_detector
from vps_torch.models.detectors import empty_track_state, random_init_
from vps_torch.tools import robustness_eval, test_robustness
from vps_torch.utils.checkpoint import save_checkpoint
from vps_torch.utils.numerics import inference_policy

CONFIG = """
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()
data = dict(test=dict(type="CityscapesVPSDataset", ann_file=r"{ann}",
                      img_prefix=r"{img}", ref_prefix=r"{img}",
                      nframes_span_test=2, test_mode=True,
                      pipeline=dict(img_scale=(96, 48))))
"""


def _renormalised(img, name, seed):
    mean, std = IMG_MEAN.astype(np.float32), IMG_STD.astype(np.float32)
    raw = j_corrupt(img * std + mean, name, 1, seed=seed)
    return ((raw - mean) / std).astype(np.float32)


def test_test_robustness_matches_predict_and_eval_map(tmp_path, capsys):
    ann, img, _ = make_synth_vps(str(tmp_path / "fix"), mode="val", n_videos=1,
                                 n_frames=2, H=64, W=128, seed=3)
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(CONFIG.format(ann=ann, img=img))
    cfg = Config.fromfile(str(cfg_path))
    det = random_init_(build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                                      "cpu"), seed=1)
    ckpt = save_checkpoint(str(tmp_path / "work"), 1, det.state_dict())
    out = tmp_path / "out"

    got = test_robustness.main([
        str(cfg_path), "--checkpoint", ckpt, "--out", str(out),
        "--corruptions", "gaussian_noise", "fog", "--severities", "1",
        "--track_cap", "32", "--device", "cpu"])
    report = json.loads((out / "robustness.json").read_text())
    assert report == got["report"]
    assert list(report) == ["clean", "gaussian_noise_s1", "fog_s1"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == report

    ds = build_dataset(cfg.data["test"])
    gts = [ds.get_ann_info(i) for i in range(2)]
    num_fg = cfg.model["bbox_head"]["num_classes"] - 1
    n_dets = 0
    for key, name in (("clean", None), ("gaussian_noise_s1", "gaussian_noise"),
                      ("fog_s1", "fog")):
        want = []
        state = empty_track_state(32, device="cpu")
        for idx in range(2):
            im, ref, meta = ds.prepare_test(idx)
            assert meta["scale_factor"] == 0.75 and meta["is_first"] == (idx == 0)
            if name:
                im = _renormalised(im, name, idx)
                ref = _renormalised(ref, name, idx + 10000)
            if meta["is_first"]:
                state = empty_track_state(32, device="cpu")
            with inference_policy():
                o, state = det.predict(
                    torch.from_numpy(im)[None], torch.from_numpy(ref)[None],
                    state, img_shape_withoutpad=meta["img_shape_withoutpad"])
            valid = o["det_valid"].numpy()
            boxes = o["det_bboxes"].numpy()[valid] / 0.75
            dets = np.concatenate([boxes, o["det_probs"].numpy()[valid, None]],
                                  1).astype(np.float32)
            labels = o["det_labels"].numpy()[valid]
            want.append([dets[labels == c] for c in range(num_fg)])
            n_dets += int(valid.sum())
        for g, w in zip(got["det_results"][key], want):
            assert len(g) == len(w) == num_fg
            for gc, wc in zip(g, w):
                assert gc.dtype == np.float32
                np.testing.assert_array_equal(gc, wc)
        m, _ = j_eval_map(want, [a["bboxes"] for a in gts],
                          [a["labels"] for a in gts], print_summary=False)
        assert report[key]["bbox_mAP"] == m
        assert report[key]["frames"] == 2 and report[key]["fps"] > 0
    assert n_dets > 0
    # the corruptions moved the frames: the runs' detections differ
    assert any(not np.array_equal(a, b) for a, b in zip(
        got["det_results"]["clean"][0], got["det_results"]["fog_s1"][0]))

    summary = robustness_eval.main([str(out / "robustness.json")])
    assert summary == tool("robustness_eval").aggregate(report)
    assert set(summary["per_corruption"]) == {"gaussian_noise", "fog"}
