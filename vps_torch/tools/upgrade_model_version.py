"""Upgrade pre-v0.6 mmdet torch checkpoints to the modern key naming (the
port's copy of the repo's ``tools/upgrade_model_version.py``): RetinaNet
tower keys ``{cls,reg}_convs.N.{weight,bias}`` became
``{cls,reg}_convs.N.conv.{weight,bias}`` when ConvModule replaced
nn.Conv2d. The port's modules use the modern names, so an old checkpoint
goes through this before it loads.

    python -m vps_torch.tools.upgrade_model_version IN.pth OUT.pth
"""

from __future__ import annotations

import argparse
import re
from collections import OrderedDict


def upgrade_state_dict(in_state_dict):
    out = OrderedDict()
    for key, val in in_state_dict.items():
        m = re.search(r"(cls_convs|reg_convs)\.\d+\.(weight|bias)", key)
        if m is not None:
            param = m.groups()[1]
            out[key.replace(param, f"conv.{param}")] = val
        else:
            out[key] = val
    return out


def convert(in_file: str, out_file: str):
    import torch

    checkpoint = torch.load(in_file, map_location="cpu")
    checkpoint["state_dict"] = upgrade_state_dict(
        checkpoint.pop("state_dict"))
    torch.save(checkpoint, out_file)


def main(argv=None):
    p = argparse.ArgumentParser(description="Upgrade model version")
    p.add_argument("in_file", help="input torch checkpoint")
    p.add_argument("out_file", help="output torch checkpoint")
    args = p.parse_args(argv)
    convert(args.in_file, args.out_file)


if __name__ == "__main__":
    main()
