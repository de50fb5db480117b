"""Convert PASCAL VOC devkit annotations to the detection "middle format"
(the port's counterpart of the repo's ``tools/convert_datasets/
pascal_voc.py``, mmdet's converter): one record per image with filename,
width, height and an ``ann`` dict of float32 bboxes (legacy 0-based,
difficult boxes split into bboxes_ignore) and int64 labels, the label ids
of the port's ``VOCDataset``. Json by default, ``--pkl`` for a pickle.

    python -m vps_torch.tools.convert_datasets.pascal_voc VOCdevkit/ -o OUT/

Writes voc{07,12,0712}_{train,val,trainval,test} for the years the devkit
holds. ``vps_torch.data.xml_style.XMLDataset`` reads the xml tree itself;
the files are for scripts that expect the middle format.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from vps_torch.data.xml_style import VOCDataset

label_ids = {name: i + 1 for i, name in enumerate(VOCDataset.CLASSES)}


def parse_xml(xml_path: str, img_path: str) -> dict:
    """One image record: difficult objects go to bboxes_ignore; the box
    coordinates shift by -1 to the 0-based frame."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    bboxes, labels, bboxes_ignore, labels_ignore = [], [], [], []
    for obj in root.findall("object"):
        label = label_ids[obj.find("name").text]
        difficult = int(obj.find("difficult").text)
        bb = obj.find("bndbox")
        bbox = [int(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
        if difficult:
            bboxes_ignore.append(bbox)
            labels_ignore.append(label)
        else:
            bboxes.append(bbox)
            labels.append(label)

    def _pack(boxes, labs):
        if not boxes:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        return (np.array(boxes, np.float32, ndmin=2) - 1,
                np.array(labs, np.int64))

    bboxes, labels = _pack(bboxes, labels)
    bboxes_ignore, labels_ignore = _pack(bboxes_ignore, labels_ignore)
    return {
        "filename": img_path,
        "width": w,
        "height": h,
        "ann": {
            "bboxes": bboxes,
            "labels": labels,
            "bboxes_ignore": bboxes_ignore,
            "labels_ignore": labels_ignore,
        },
    }


def cvt_annotations(devkit_path: str, years, split: str, out_file: str):
    """The merged record list of ``split`` over ``years``, written to
    ``out_file``; None (and nothing written) if a year's split file is
    missing."""
    if not isinstance(years, list):
        years = [years]
    annotations = []
    for year in years:
        filelist = osp.join(devkit_path,
                            f"VOC{year}/ImageSets/Main/{split}.txt")
        if not osp.isfile(filelist):
            print(f"filelist does not exist: {filelist}, "
                  f"skip voc{year} {split}")
            return None
        with open(filelist) as f:
            img_names = [ln.strip() for ln in f if ln.strip()]
        for name in img_names:
            annotations.append(parse_xml(
                osp.join(devkit_path, f"VOC{year}/Annotations/{name}.xml"),
                f"VOC{year}/JPEGImages/{name}.jpg"))
    dump(annotations, out_file)
    return annotations


def dump(annotations, out_file: str) -> None:
    if out_file.endswith(".pkl"):
        with open(out_file, "wb") as f:
            pickle.dump(annotations, f)
    else:
        def _default(o):
            return o.tolist() if isinstance(o, np.ndarray) else o
        with open(out_file, "w") as f:
            json.dump(annotations, f, default=_default)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert PASCAL VOC annotations to middle format")
    ap.add_argument("devkit_path", help="pascal voc devkit path")
    ap.add_argument("-o", "--out-dir", help="output path")
    ap.add_argument("--pkl", action="store_true",
                    help="write pickle instead of json")
    args = ap.parse_args(argv)
    devkit_path = args.devkit_path
    out_dir = args.out_dir or devkit_path
    os.makedirs(out_dir, exist_ok=True)
    ext = ".pkl" if args.pkl else ".json"

    years = []
    if osp.isdir(osp.join(devkit_path, "VOC2007")):
        years.append("2007")
    if osp.isdir(osp.join(devkit_path, "VOC2012")):
        years.append("2012")
    if "2007" in years and "2012" in years:
        years.append(["2007", "2012"])
    if not years:
        raise IOError(f'The devkit path {devkit_path} contains neither '
                      f'"VOC2007" nor "VOC2012" subfolder')
    for year in years:
        prefix = {"2007": "voc07", "2012": "voc12"}.get(
            year if isinstance(year, str) else None, "voc0712")
        for split in ["train", "val", "trainval"]:
            name = f"{prefix}_{split}"
            print(f"processing {name} ...")
            cvt_annotations(devkit_path, year, split,
                            osp.join(out_dir, name + ext))
        if not isinstance(year, list):
            name = f"{prefix}_test"
            print(f"processing {name} ...")
            cvt_annotations(devkit_path, year, "test",
                            osp.join(out_dir, name + ext))
    print("Done!")


if __name__ == "__main__":
    main()
