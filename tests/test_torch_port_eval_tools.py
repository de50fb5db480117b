"""Port parity, the detection evaluation tools: vps_torch.tools.coco_eval,
voc_eval and coco_error_analysis (``--no-plots``, and once with its plots)
run in this process against the repo's tools/ scripts (their sys.argv
patched, their stdout captured) on the same synthetic fixture
(CityscapesDataset), VOC fixture (with ignored boxes) and seeded
detections: the printed numbers, the returned ones and
error_analysis.json are equal; the ground truth as its own detections
scores AP 1.0 at every threshold."""

import json
import os
import pickle

import numpy as np
import pytest

from test_torch_port_image_datasets import _write_xml
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from repo_tools import run_tool
from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.data.synth import make_synth_vps
from vps_torch.tools import coco_error_analysis, coco_eval, voc_eval

CONFIG = """
data = dict(val=dict(type="{kind}", ann_file=r"{ann}", img_prefix=r"{img}",
                     {extra}test_mode=True))
"""


def _dets(rng, dataset, num_classes):
    """Per image, per class: each gt of the class jittered (some far off)
    plus random boxes; the scores drawn from 6 levels so that ties occur."""
    out = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        gts = np.concatenate([ann["bboxes"], ann["bboxes_ignore"]])
        labels = np.concatenate([ann["labels"], ann.get(
            "labels_ignore", np.zeros(len(ann["bboxes_ignore"]), np.int64))])
        per_cls = []
        for c in range(num_classes):
            g = gts[labels == c + 1]
            jit = rng.normal(0, 3, g.shape) * (rng.rand(len(g), 1) < 0.85)
            n = rng.randint(0, 3)
            xy = rng.uniform(0, 200, (n, 2))
            extra = np.concatenate([xy, xy + rng.uniform(4, 50, (n, 2))], 1)
            boxes = np.concatenate([g + jit, extra]).astype(np.float32)
            scores = rng.randint(1, 7, len(boxes)) / 6.0
            per_cls.append(np.concatenate([boxes, scores[:, None]],
                                          1).astype(np.float32))
        out.append(per_cls)
    return out


def _gt_dets(dataset, num_classes):
    """The ground truth as its own detections, score 1."""
    out = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        out.append([np.concatenate(
            [ann["bboxes"][ann["labels"] == c + 1],
             np.ones(((ann["labels"] == c + 1).sum(), 1), np.float32)], 1)
            for c in range(num_classes)])
    return out


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_tools")
    ann, img, _ = make_synth_vps(str(root / "synth"), mode="val", n_videos=2,
                                 n_frames=3, seed=7)
    city = root / "city.py"
    city.write_text(CONFIG.format(kind="CityscapesDataset", ann=ann, img=img,
                                  extra=""))
    voc = str(root / "VOC2007")
    os.makedirs(voc)
    split = _write_xml(voc, [f"{i:06d}" for i in range(5)],
                       ["car", "person", "dog", "car"], None,
                       np.random.RandomState(1), os.path.join(voc, "val.txt"))
    voc_cfg = root / "voc.py"
    voc_cfg.write_text(CONFIG.format(kind="VOCDataset", ann=split, img=voc,
                                     extra=""))
    rng = np.random.RandomState(2)
    paths = dict(root=root, ann=ann, city=str(city), voc=str(voc_cfg))
    for name, cfg, n in (("city", city, 8), ("voc", voc_cfg, 20)):
        ds = build_dataset(Config.fromfile(str(cfg)).data["val"])
        for kind, dets in (("dets", _dets(rng, ds, n)), ("gt", _gt_dets(ds, n))):
            path = root / f"{name}_{kind}.pkl"
            with open(path, "wb") as f:
                pickle.dump(dets, f)
            paths[f"{name}_{kind}"] = str(path)
    return paths


def _both(capsys, port_main, tool, argv):
    got = port_main([str(a) for a in argv])
    out = capsys.readouterr().out
    run_tool(tool, argv)
    assert out == capsys.readouterr().out
    return got, out


@pytest.mark.parametrize("cfg", ["city", "voc"])
def test_coco_eval_matches_repo_tool(fixture, capsys, cfg):
    got, out = _both(capsys, coco_eval.main, "coco_eval",
                     [fixture[f"{cfg}_dets"], fixture[cfg]])
    lines = out.splitlines()
    assert len(lines) == 11 and lines[-1].startswith("AP@[0.50:0.95]: ")
    assert [f"{k}: {v:.4f}" for k, v in got.items()] == lines
    assert 0 < got["AP@0.95"] < got["AP@0.50"] < 1
    perfect, out = _both(capsys, coco_eval.main, "coco_eval",
                         [fixture[f"{cfg}_gt"], fixture[cfg]])
    assert all(v == 1.0 for v in perfect.values()), perfect


@pytest.mark.parametrize("cfg", ["city", "voc"])
@pytest.mark.parametrize("mode", ["area", "11points"])
def test_voc_eval_matches_repo_tool(fixture, capsys, cfg, mode):
    for thr in ("0.5", "0.7"):
        (m, results), out = _both(
            capsys, voc_eval.main, "voc_eval",
            [fixture[f"{cfg}_dets"], fixture[cfg], "--iou-thr", thr,
             "--mode", mode])
        assert out.splitlines()[-1].split()[-1] == f"{m:.3f}" and 0 < m < 1
    (m, _), _ = _both(capsys, voc_eval.main, "voc_eval",
                      [fixture[f"{cfg}_gt"], fixture[cfg], "--mode", mode])
    assert m == 1.0


def _coco_results(fixture, kind):
    """The pickle's detections in COCO's results format, and its path."""
    with open(fixture[f"city_{kind}"], "rb") as f:
        dets = pickle.load(f)
    with open(fixture["ann"]) as f:
        images = json.load(f)["images"]
    res = [dict(image_id=im["id"], category_id=c + 1,
                bbox=[float(d[0]), float(d[1]), float(d[2] - d[0]),
                      float(d[3] - d[1])], score=float(d[4]))
           for im, per_cls in zip(images, dets)
           for c, cls_dets in enumerate(per_cls) for d in cls_dets]
    path = fixture["root"] / f"results_{kind}.json"
    path.write_text(json.dumps(res))
    return str(path)


def test_coco_error_analysis_matches_repo_tool(fixture, capsys, tmp_path):
    """--no-plots against the repo tool: the printed line and every number
    of error_analysis.json; the ground truth as its detections reads C75 1
    for each class with a gt; the plots (matplotlib) once, for the port."""
    for kind in ("dets", "gt"):
        res = _coco_results(fixture, kind)
        out, jout = tmp_path / f"port_{kind}", tmp_path / f"jax_{kind}"
        got = coco_error_analysis.main(
            [res, str(out), "--ann", fixture["ann"], "--no-plots"])
        lines = capsys.readouterr().out.replace(str(out), "OUT")
        run_tool("coco_error_analysis",
                 [res, jout, "--ann", fixture["ann"], "--no-plots"])
        assert lines == capsys.readouterr().out.replace(str(jout), "OUT")
        assert lines.splitlines()[-1].startswith("allclass AP (allarea): C75=")
        with open(out / "bbox" / "error_analysis.json") as f:
            written = json.load(f)
        with open(jout / "bbox" / "error_analysis.json") as f:
            assert written == json.load(f) == got["bbox"]
        assert os.listdir(out / "bbox") == ["error_analysis.json"]
        person, car = written["person"], written["car"]
        if kind == "gt":
            assert person["C75"]["allarea"] == car["C75"]["allarea"] == 1.0
            assert written["rider"]["C75"]["allarea"] == 0.0  # no gt
        else:
            assert 0 < car["C75"]["allarea"] < car["Oth"]["allarea"] <= 1
    capsys.readouterr()
    plots = tmp_path / "plots"
    coco_error_analysis.main([res, str(plots), "--ann", fixture["ann"]])
    pngs = sorted(os.listdir(plots / "bbox"))
    assert len(pngs) == 4 * (8 + 1) + 1 and "bbox-allclass-allarea.png" in pngs
