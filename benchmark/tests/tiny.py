"""Cells of the benchmark cut to a CPU test's size: the ResNet-18 trunk,
TinyFlow in FlowNet2's place, small frames and few of them. Everything
else (entries, generator, readers, reference, comparison) is the
benchmark's own."""

from __future__ import annotations

import argparse
import copy
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import run  # noqa: E402

TRAFFIC = {
    "video": dict(height=128, width=256, videos=2, frames=4, chunk=2,
                  streams=2, things=3, pan=[2, 4]),
    "train": dict(height=128, width=256, batches=4, things=3, max_gt=8,
                  pan=[3, 5]),
    "images": dict(height=128, width=192, pad=[128, 192], images=4, things=3,
                   check_every=1, check_images=2),
}


def _tiny_model(model):
    model = copy.deepcopy(model)
    model["backbone"]["depth"] = 18
    model["neck"]["in_channels"] = [64, 128, 256, 512]
    if model.get("flow") is not None or "extra_neck" in model:
        model["flow"] = dict(model.get("flow") or {}, type="TinyFlow")
    return model


def cell(name):
    """The cell ``name`` of the benchmark at the tiny size."""
    c = run.load_cell(name)
    cfg = c["config_file"]
    for key in ("model", "train_model"):
        if key in cfg:
            cfg[key] = _tiny_model(cfg[key])
    test = cfg["test_cfg"]
    if "rpn" in test:
        test["rpn"].update(nms_pre=128, nms_post=128, max_num=128)
    if "panoptic" in test:
        test["panoptic"]["max_det"] = 16
    if "train_cfg" in cfg:
        cfg["train_cfg"]["rpn"]["sampler"]["num"] = 64
        cfg["train_cfg"]["rpn_proposal"].update(nms_pre=200, nms_post=200,
                                                max_num=128)
        cfg["train_cfg"]["rcnn"]["sampler"]["num"] = 64
    c["traffic"].update(TRAFFIC[c["entry"]])
    return c


def run_cell(name, seconds=1.0, trace=0, seed=3, control=0, c=None,
             device="cpu"):
    """Run the tiny cell (``c``, or ``cell(name)``) on ``device`` without
    the look for a card; returns (exit code, result dict or None, standard
    error)."""
    c = c or cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(args, out=out, err=err, device=device, cell=c,
                 chips_check=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
