"""Port parity, VIPER's data and scoring and the drawing and flow utilities:
each held to vps_tpu's, exactly, on the CPU.

- The VIPER evaluator (``vps_torch.eval.viper``): ``viper_vpq_compute``,
  ``evaluate_panoptic_viper`` and ``evaluate_panoptic_from_files`` on
  tests/test_viper_eval.py's synthetic cases (a drifting instance over
  every window, a track-id switch, the SIZE_THR skip of a small GT, the
  tube-area threshold), results dicts and the written ``*_vpq_nfNN.txt``
  tables equal.
- ``ViperDataset``: the classes from the json, ``prepare_test`` and
  ``prepare_train`` byte-equal on a 72x128 (16:9) VIPER-format fixture
  (``viper_fixture.py``) under the train pipeline's scale, ratio jitter and
  crop cut by 16, so the rescaled frame can come out narrower than the crop,
  as VIPER's 1080x1920 frames do under the 800x1600 crop.
- ``vps_torch.tools.eval_ipq`` against the repo's ``tools/eval_ipq.py`` on
  the same artifacts: numbers, printed line and ``vpq-0.txt``.
- ``vps_torch.utils.visualize`` and ``vps_torch.utils.flow`` against
  vps_tpu's on the same arrays.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vps_tpu.data.dataset import build_dataset as j_build_dataset
from vps_tpu.eval import unified as j_unified
from vps_tpu.eval import viper as j_viper
from vps_tpu.eval.vpq import vpq_compute_video as j_vpq_compute_video
from vps_tpu.utils import flow as j_flow
from vps_tpu.utils import visualize as j_vis

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_viper_eval import _2ch, _frame
from viper_fixture import make_viper_fixture

from vps_torch.data import DATASETS, ViperDataset, build_dataset
from vps_torch.eval import unified, viper
from vps_torch.eval.vpq import vpq_compute_video
from vps_torch.tools import eval_ipq
from vps_torch.utils import flow, visualize

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 64


def _gt(pkg, frames_2ch, cats):
    """(gt_json, gt_pan_rgb) per frame through ``pkg``'s encoder."""
    pans, anns = pkg.encode_panoptic_video(frames_2ch, cats)
    return list(zip(anns, pans))


def _same_tables(a, b):
    names = sorted(n for n in os.listdir(a) if n.endswith(".txt"))
    assert names and names == sorted(n for n in os.listdir(b)
                                     if n.endswith(".txt"))
    for n in names:
        assert Path(a, n).read_text() == Path(b, n).read_text(), n
    return names


def _evaluator(tmp_path):
    cats = viper.default_viper_categories()
    assert cats == j_viper.default_viper_categories()
    assert (viper.SIZE_THR, viper.VIPER_WINDOWS) == (j_viper.SIZE_THR,
                                                    j_viper.VIPER_WINDOWS)
    # 2 videos x 5 frames, a drifting 40x40 instance; then a track-id switch
    videos = [[_frame((10, 5 + 2 * t, 50, 45 + 2 * t), track_id=1 + v)
               for t in range(5)] for v in range(2)]
    switched = [list(v) for v in videos]
    for t in range(2, 5):
        f = switched[0][t].copy()
        f[..., 2][f[..., 2] == 1] = 9
        switched[0][t] = f
    for preds in (videos, switched):
        outs = []
        for pkg, ev, name in ((j_unified, j_viper, "jax"),
                              (unified, viper, "port")):
            gt = [_gt(pkg, v, cats) for v in videos]
            out = str(tmp_path / f"eval_{name}")
            outs.append((ev.evaluate_panoptic_viper(
                preds, gt, categories=cats, output_dir=out,
                windows=(1, 5)), out))
        assert outs[0][0] == outs[1][0]
        assert _same_tables(outs[0][1], outs[1][1]) == [
            "viper_vpq_nf01.txt", "viper_vpq_nf05.txt"]
    assert outs[1][0][5]["Things"]["pq"] < 1.0  # the switch splits the tube

    # SIZE_THR: a 40x40 GT found, an 8x8 one (64 px < 32^2) missed
    sem = np.full((H, W), 2, np.uint8)
    track = np.zeros((H, W), np.uint8)
    sem[10:50, 10:50], track[10:50, 10:50] = 13, 1
    sem[55:63, 55:63], track[55:63, 55:63] = 13, 2
    pred = _frame((10, 10, 50, 50), thing_cls=13, track_id=1, stuff_cls=2)
    # ... and a 20x20 instance: skipped in one frame, a 2000 px tube in 5
    small = [_frame((20, 20, 40, 40)) for _ in range(5)]
    for pkg, compute in ((j_unified, j_vpq_compute_video),
                         (unified, vpq_compute_video)):
        gt = _gt(pkg, [_2ch(sem, track)], cats)[0]
        pans, anns = pkg.encode_panoptic_video([pred], cats)
        frames = [(gt[0], anns[0], gt[1], pans[0])]
        ps, pa = pkg.encode_panoptic_video(small, cats)
        tube = [(a, a2, p, p2) for (a, p), a2, p2
                in zip(_gt(pkg, small, cats), pa, ps)]
        stats = [(s[13].tp, s[13].fn) for s in (
            compute(frames, cats, 1, size_thr=viper.SIZE_THR),
            compute(frames, cats, 1, size_thr=0),
            compute(tube, cats, 1, size_thr=viper.SIZE_THR),
            compute(tube, cats, 5, size_thr=viper.SIZE_THR))]
        assert stats == [(1, 0), (1, 1), (0, 0), (1, 0)], stats
    outs = []
    for pkg, ev, name in ((j_unified, j_viper, "jax"),
                          (unified, viper, "port")):
        gt = _gt(pkg, [_2ch(sem, track)], cats)[0]
        pans, anns = pkg.encode_panoptic_video([pred], cats)
        out = str(tmp_path / f"thr_{name}")
        outs.append((ev.viper_vpq_compute(
            [[(gt[0], anns[0], gt[1], pans[0])]], cats, 1, output_dir=out,
            save_name="thr"), out))
    assert outs[0][0] == outs[1][0]
    assert outs[1][0][0]["Things"]["pq"] == 1.0  # the small GT skipped
    _same_tables(outs[0][1], outs[1][1])

    # from files: GT json + colour PNGs, 2 videos of 4 frames, a switch in
    # the second video's predictions
    gt_dir = tmp_path / "gt_viper_pans"
    gt_dir.mkdir()
    vids = [[_frame((10, 5 + 2 * t, 50, 45 + 2 * t), track_id=1 + v)
             for t in range(4)] for v in range(2)]
    images, annotations = [], []
    for v, frames_2ch in enumerate(vids):
        pans, anns = unified.encode_panoptic_video(frames_2ch, cats)
        for t, (pan, ann) in enumerate(zip(pans, anns)):
            name = f"{v:03d}_{t:05d}.jpg"
            cv2.imwrite(str(gt_dir / name.replace(".jpg", ".png")),
                        pan[..., ::-1])
            images.append(dict(id=len(images), file_name=name, height=H,
                               width=W))
            annotations.append(dict(ann, image_id=len(annotations)))
    gt_json = tmp_path / "gt.json"
    gt_json.write_text(json.dumps(dict(images=images, annotations=annotations,
                                       categories=list(cats.values()))))
    flat = [f for v in vids for f in v]
    flat[5] = flat[5].copy()
    flat[5][..., 2][flat[5][..., 2] == 2] = 7
    outs = []
    for ev, name in ((j_viper, "jax"), (viper, "port")):
        out = str(tmp_path / f"files_{name}")
        outs.append((ev.evaluate_panoptic_from_files(
            flat, out, str(gt_json), str(gt_dir), n_video=2,
            windows=(1, 4)), out))
    assert outs[0][0] == outs[1][0]
    assert outs[1][0][1]["All"]["pq"] == 1.0 > outs[1][0][4]["All"]["pq"]
    _same_tables(outs[0][1], outs[1][1])
    for sub in ("pan", "pan_2ch"):
        names = sorted(os.listdir(Path(outs[0][1], sub)))
        assert len(names) == 8 and names == sorted(
            os.listdir(Path(outs[1][1], sub)))
        for n in names:
            assert (Path(outs[0][1], sub, n).read_bytes()
                    == Path(outs[1][1], sub, n).read_bytes()), (sub, n)
    for n in ("gt.json", "pred.json"):
        assert (json.loads(Path(outs[0][1], n).read_text())
                == json.loads(Path(outs[1][1], n).read_text()))


def _dataset(fix):
    assert "ViperDataset" in DATASETS
    # VIPER's geometry cut by 16: the train scale (2048, 1024) with the
    # ratio jitter 0.8-1.5 and the 800x1600 crop, the test scale
    train = dict(type="ViperDataset", ann_file=fix["train_ann"],
                 img_prefix=fix["train_img"], ref_prefix=fix["train_img"],
                 seg_prefix=fix["train_seg"], ref_ann_file=fix["train_ann"],
                 offsets=[-2, -1, 1, 2],
                 pipeline=dict(img_scale=(128, 64), crop_size=(50, 100),
                               max_gt=8))
    test = dict(type="ViperDataset", ann_file=fix["val_ann"],
                img_prefix=fix["val_img"], ref_prefix=fix["val_img"],
                nframes_span_test=3, test_mode=True,
                pipeline=dict(img_scale=(128, 64)))
    ours, theirs = build_dataset(train), j_build_dataset(train)
    assert type(ours) is ViperDataset
    assert ours.CLASSES == theirs.CLASSES and len(ours.CLASSES) == 10
    narrow = 0
    for seed in range(8):
        idx = seed % len(ours)
        a = ours.prepare_train(idx, np.random.RandomState(seed))
        b = theirs.prepare_train(idx, np.random.RandomState(seed))
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the crop's padding: image columns past the rescaled width
        narrow += int(not np.any(a["img"][:, -1]))
    assert narrow > 0, "no draw came out narrower than the crop"
    ours, theirs = build_dataset(test), j_build_dataset(test)
    assert len(ours) == len(theirs) == 6
    for idx in range(len(ours)):
        a, b = ours.prepare_test(idx), theirs.prepare_test(idx)
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert a[2] == b[2]
    for t in ("CocoDataset", "CityscapesDataset"):
        with pytest.raises(ValueError, match="not ported"):
            build_dataset(dict(train, type=t))


def _eval_ipq(tmp_path, fix, capsys):
    """A submission from the fixture's GT maps, a thing shifted and one
    dropped, through both tools."""
    with open(fix["gt_json"]) as f:
        gt = json.load(f)
    cats = {c["id"]: c for c in gt["categories"]}
    sub = tmp_path / "submission"
    maps = {}
    for k, im in enumerate(gt["images"]):
        pan = cv2.imread(os.path.join(fix["gt_dir"], im["file_name"]))[..., ::-1]
        pan = pan.astype(np.int64)
        ids = pan[..., 0] + 256 * pan[..., 1] + 65536 * pan[..., 2]
        m = np.full(ids.shape + (3,), 255, np.uint8)
        m[..., 2] = 0
        for n, seg in enumerate(gt["annotations"][k]["segments_info"]):
            region = ids == seg["id"]
            if k % 2 and n == len(gt["annotations"][k]["segments_info"]) - 1:
                region = np.roll(region, 3, axis=1)
            if k == 4 and cats[seg["category_id"]]["isthing"]:
                continue
            m[region, 0] = seg["category_id"]
            m[region, 2] = n + 1 if cats[seg["category_id"]]["isthing"] else 0
        maps[im["file_name"].replace(".png", ".jpg")] = m
    unified.save_panoptic_outputs(maps, cats, str(sub), lambda_=1,
                                  labeled_fid=0, nframes_per_video=3)
    args = ["--submit_dir", str(sub), "--truth_dir", fix["gt_dir"],
            "--pan_gt_json_file", fix["gt_json"]]
    spec = importlib.util.spec_from_file_location(
        "repo_eval_ipq", REPO / "tools" / "eval_ipq.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    sys.argv = ["eval_ipq.py"] + args
    try:
        tool.main()
    finally:
        sys.argv = argv
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    want_table = (sub / "vpq-0.txt").read_text()
    (sub / "vpq-0.txt").unlink()
    got = eval_ipq.main(args)
    assert capsys.readouterr().out.strip().splitlines()[-1] == want_line
    assert (sub / "vpq-0.txt").read_text() == want_table
    assert want_line == ("pq_all: %.4f  pq_thing: %.4f  pq_stuff: %.4f"
                         % got)
    assert 0.0 < got[1] < 100.0 and 0.0 < got[2] < 100.0


def _drawing(tmp_path):
    rng = np.random.RandomState(0)
    for n in (1, 5, 79, 200):
        np.testing.assert_array_equal(visualize.palette(n), j_vis.palette(n))
        np.testing.assert_array_equal(visualize.palette(n, bgr=True),
                                      j_vis.palette(n, bgr=True))
    for rgb in (True, False):
        np.testing.assert_array_equal(visualize.colormap(rgb),
                                      j_vis.colormap(rgb))
    img = rng.randint(0, 256, (48, 80, 3)).astype(np.uint8)
    boxes = np.concatenate([rng.uniform(0, 40, (6, 2)),
                            rng.uniform(40, 79, (6, 2))], 1)[:, [0, 1, 2, 3]]
    scores = rng.uniform(0.0, 1.0, (6, 1))
    labels = rng.randint(0, 8, 6)
    masks = rng.rand(6, 48, 80) > 0.7
    names = [f"c{i}" for i in range(8)]
    for kw in (dict(bboxes=boxes, labels=labels),
               dict(bboxes=np.concatenate([boxes, scores], 1), labels=labels,
                    masks=masks, class_names=names, num_keep=5),
               dict(bboxes=boxes, labels=labels, masks=masks, num_keep=4)):
        a = visualize.draw_detections(img, out_file=str(tmp_path / "a.png"),
                                      **kw)
        b = j_vis.draw_detections(img, out_file=str(tmp_path / "b.png"), **kw)
        np.testing.assert_array_equal(a, b)
        assert (tmp_path / "a.png").read_bytes() == \
            (tmp_path / "b.png").read_bytes()
    outputs = dict(det_bboxes=boxes, det_scores=scores[:, 0],
                   det_labels=labels, num_keep=np.int32(4), det_masks=masks)
    np.testing.assert_array_equal(visualize.show_result(img, outputs, names),
                                  j_vis.show_result(img, outputs, names))
    pan = rng.randint(0, 23 * 1000 + 40, (30, 40))
    for div in (1, 1000):
        np.testing.assert_array_equal(visualize.panoptic_to_color(pan, div),
                                      j_vis.panoptic_to_color(pan, div))


def _flow(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 8, 12, 3).astype(np.float32)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    np.testing.assert_array_equal(
        flow.denormalize(torch.from_numpy(img), mean, std).numpy(),
        np.asarray(j_flow.denormalize(jnp.asarray(img), mean, std)))
    f = (rng.randn(9, 13, 2) * 5).astype(np.float32)
    flow.write_flo(str(tmp_path / "a.flo"), f)
    j_flow.write_flo(str(tmp_path / "b.flo"), f)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    np.testing.assert_array_equal(flow.read_flo(str(tmp_path / "b.flo")), f)
    np.testing.assert_array_equal(j_flow.read_flo(str(tmp_path / "a.flo")), f)
    f[0, 0, 0], f[1, 2, 1] = np.nan, np.inf
    f[2, 3] = (3.0, 4.0)  # radius 5: the wheel's edge at max_flow 5
    for mx in (None, 3.0, 5.0):
        np.testing.assert_array_equal(flow.flow_to_rgb(f, mx),
                                      j_flow.flow_to_rgb(f, mx))


def test_viper_data_scoring_and_utils_match_jax(tmp_path, capsys):
    fix = make_viper_fixture(str(tmp_path / "viper_vps"), val_videos=2,
                             val_frames=3, h=72, w=128)
    _evaluator(tmp_path)
    _dataset(fix)
    _eval_ipq(tmp_path, fix, capsys)
    _drawing(tmp_path)
    _flow(tmp_path)
