"""Port parity, the image-level datasets: CocoDataset and CityscapesDataset
on the synthetic fixture (vps_torch.data.synth), VOCDataset and
WIDERFaceDataset on an XML fixture written as tests/test_xml_dataset.py
writes one, build_dataset for every type, and the Pascal VOC converter's
output, each against vps_tpu's: the same samples, array for array and
exactly, for the same rng."""

import json
import os
import pickle

import numpy as np
import pytest

from vps_tpu.data import build_dataset as j_build_dataset

from test_torch_port_data import _equal
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from repo_tools import run_tool, tool
from vps_torch.data import DATASETS, build_dataset
from vps_torch.data.synth import make_synth_vps
from vps_torch.tools.convert_datasets import pascal_voc

cv2 = pytest.importorskip("cv2")

H, W = 48, 96
PIPE = dict(img_scale=(W, H), ratio_range=(1.0, 1.0), crop_size=(H, W),
            max_gt=6)

XML = """<annotation>
  <folder>{folder}</folder>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""
OBJ = """<object>
  <name>{name}</name>
  <difficult>{difficult}</difficult>
  <bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>
</object>
"""


def _write_xml(prefix, ids, names, folder, rng, split):
    """Annotations/<id>.xml and the jpgs under ``prefix`` (WIDER Face's in
    per-event folders), the split file listing ``ids``: per image a box of
    each name, the second difficult, the third under 8 pixels; WIDER Face's
    also one named by no class."""
    os.makedirs(os.path.join(prefix, "Annotations"), exist_ok=True)
    img_dir = os.path.join(prefix, folder or "JPEGImages")
    os.makedirs(img_dir, exist_ok=True)
    for k, iid in enumerate(ids):
        objs = ""
        for j, name in enumerate(names):
            x0, y0 = rng.randint(1, W // 2), rng.randint(1, H // 2)
            size = 5 if j == 2 else rng.randint(10, 40)
            objs += OBJ.format(name=name, difficult=int(j == 1), x0=x0, y0=y0,
                               x1=min(x0 + size, W), y1=min(y0 + size, H))
        if folder:
            objs += OBJ.format(name="unicorn", difficult=0, x0=2, y0=2,
                               x1=20, y1=20)
        with open(os.path.join(prefix, "Annotations", iid + ".xml"), "w") as f:
            f.write(XML.format(folder=folder or "VOC2007", w=W, h=H,
                               objects=objs))
        cv2.imwrite(os.path.join(img_dir, iid + ".jpg"),
                    rng.randint(0, 255, (H, W, 3), np.uint8))
    with open(split, "w") as f:
        f.write("\n".join(ids) + "\n")
    return split


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_datasets")
    rng = np.random.RandomState(0)
    ann, img, _ = make_synth_vps(str(root / "synth"), mode="val", n_videos=2,
                                 n_frames=2, H=H, W=W, seed=5)
    devkit = root / "VOCdevkit"
    voc = str(devkit / "VOC2007")
    ids = [f"{i:06d}" for i in range(4)]
    os.makedirs(os.path.join(voc, "ImageSets", "Main"))
    _write_xml(voc, ids, ["car", "person", "dog", "cat"], None, rng,
               os.path.join(voc, "ImageSets", "Main", "trainval.txt"))
    for split, part in (("train", ids[:2]), ("val", ids[2:]), ("test", ids[:1])):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("\n".join(part) + "\n")
    wider = str(root / "WIDER")
    wids = [f"0_Parade_{i}" for i in range(3)]
    _write_xml(wider, wids, ["face", "face", "face"], "0--Parade", rng,
               os.path.join(wider, "val.txt"))
    return dict(
        CocoDataset=dict(ann_file=ann, img_prefix=img),
        CityscapesDataset=dict(ann_file=ann, img_prefix=img),
        VOCDataset=dict(ann_file=os.path.join(voc, "ImageSets", "Main",
                                              "trainval.txt"),
                        img_prefix=voc),
        WIDERFaceDataset=dict(ann_file=os.path.join(wider, "val.txt"),
                              img_prefix=wider),
        devkit=str(devkit))


def _pair(cfg):
    return build_dataset(dict(cfg)), j_build_dataset(dict(cfg))


@pytest.mark.parametrize("kind", ["CocoDataset", "CityscapesDataset",
                                  "VOCDataset", "WIDERFaceDataset"])
def test_samples_match_jax(fixtures, kind):
    """prepare_train with the same rng (and min_size for the XML types),
    prepare_test and get_ann_info, every index."""
    extra = dict(min_size=8) if kind in ("VOCDataset", "WIDERFaceDataset") else {}
    ds, jds = _pair(dict(fixtures[kind], type=kind, pipeline=dict(PIPE),
                         **extra))
    assert type(ds).__name__ == type(jds).__name__ == kind
    assert ds.CLASSES == jds.CLASSES and len(ds) == len(jds) >= 3
    n = 0
    for idx in range(len(ds)):
        _equal(ds.get_ann_info(idx), jds.get_ann_info(idx))
        for seed in (0, 3):
            got = ds.prepare_train(idx, np.random.RandomState(seed))
            _equal(got, jds.prepare_train(idx, np.random.RandomState(seed)))
            n += got is not None
    assert n >= 4
    if kind != "CocoDataset":
        ann = ds.get_ann_info(0)
        assert len(ann["bboxes"]) and set(ann["labels"]) <= set(
            range(1, len(ds.CLASSES) + 1))
    if "min_size" in extra:
        assert len(ds.get_ann_info(0)["bboxes_ignore"]) >= 1
    ts, jts = _pair(dict(fixtures[kind], type=kind, test_mode=True,
                         pipeline=dict(img_scale=(W, H))))
    for idx in range(len(ts)):
        got = ts.prepare_test(idx)
        _equal(got, jts.prepare_test(idx))
        if kind in ("VOCDataset", "WIDERFaceDataset"):
            # each image its own video: first, and its own reference
            assert got[2]["is_first"]
            np.testing.assert_array_equal(got[0], got[1])


def test_build_dataset_every_type(fixtures):
    """Every type of DATASETS (and the wrappers) builds the JAX package's
    counterpart's contents; an unknown type raises."""
    ann, img = fixtures["CocoDataset"]["ann_file"], fixtures["CocoDataset"]["img_prefix"]
    cfgs = {k: dict(fixtures[k], type=k) for k in (
        "CocoDataset", "CityscapesDataset", "VOCDataset", "WIDERFaceDataset")}
    cfgs["XMLDataset"] = dict(fixtures["VOCDataset"], type="XMLDataset")
    for k in ("CityscapesVPSDataset", "ViperDataset"):
        cfgs[k] = dict(type=k, ann_file=ann, img_prefix=img, test_mode=True)
    assert set(cfgs) == set(DATASETS)
    cfgs["RepeatDataset"] = dict(type="RepeatDataset", times=3,
                                 dataset=cfgs["CocoDataset"])
    cfgs["ConcatDataset"] = dict(type="ConcatDataset", datasets=[
        cfgs["VOCDataset"], cfgs["WIDERFaceDataset"]])
    for kind, cfg in cfgs.items():
        ds, jds = _pair(cfg)
        assert type(ds).__name__ == type(jds).__name__, kind
        assert len(ds) == len(jds) and ds.CLASSES == jds.CLASSES, kind
        assert getattr(ds, "repeat_times", 1) == getattr(jds, "repeat_times", 1)
        _equal(ds.get_ann_info(len(ds) - 1), jds.get_ann_info(len(jds) - 1))
    assert build_dataset(cfgs["CocoDataset"]).CLASSES == (
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle")
    assert build_dataset(cfgs["VOCDataset"]).year == 2007
    with pytest.raises(ValueError):
        build_dataset(dict(type="NoSuchDataset"))


def test_pascal_voc_converter_matches_jax(fixtures, tmp_path):
    """parse_xml, cvt_annotations and the files main writes (json and
    pkl) against tools/convert_datasets/pascal_voc.py's."""
    devkit = fixtures["devkit"]
    jtool = tool("convert_datasets/pascal_voc")
    assert pascal_voc.label_ids == jtool.label_ids
    xml = os.path.join(devkit, "VOC2007", "Annotations", "000001.xml")
    _equal(pascal_voc.parse_xml(xml, "x.jpg"), jtool.parse_xml(xml, "x.jpg"))
    for ext, args in ((".json", []), (".pkl", ["--pkl"])):
        out, jout = tmp_path / ("port" + ext), tmp_path / ("jax" + ext)
        pascal_voc.main([devkit, "-o", str(out)] + args)
        run_tool("convert_datasets/pascal_voc", [devkit, "-o", jout] + args)
        names = sorted(os.listdir(out))
        assert names == sorted(os.listdir(jout)) == sorted(
            f"voc07_{s}{ext}" for s in ("train", "val", "trainval", "test"))
        for name in names:
            if ext == ".json":
                with open(out / name) as f, open(jout / name) as g:
                    got, want = json.load(f), json.load(g)
                assert got == want
            else:
                with open(out / name, "rb") as f, open(jout / name, "rb") as g:
                    got, want = pickle.load(f), pickle.load(g)
                _equal(got, want)
            assert len(got) >= 1
    recs = pascal_voc.cvt_annotations(devkit, "2007", "trainval",
                                      str(tmp_path / "tv.json"))
    assert len(recs) == 4 and len(recs[0]["ann"]["bboxes_ignore"]) == 1
    assert pascal_voc.cvt_annotations(devkit, "2012", "train",
                                      str(tmp_path / "none.json")) is None
