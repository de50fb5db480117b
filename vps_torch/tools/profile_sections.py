"""Per-stage time of a FuseTrack frame (the port's counterpart of the repo's
``tools/profile_sections.py``), under the repo tool's flags.

    python -m vps_torch.tools.profile_sections [--size 1024x2048] [--iters 5]
        [--preset half-flow] [--device cuda|cpu]

A thin entry over ``python -m vps_torch.profile``, which times the same
stages (flownet2, backbone_fpn, fuse_neck, semantic_head, rpn, bbox_dets,
track, mask_fusion) by the named ranges of ``PanopticFuseTrack.predict``,
with seeded random weights at the R-50 ``--preset``: after two warm-up
frames, ``--iters`` steady frames on the host clock, then ``--iters`` more
in one profile; each stage's device (kernel) time and host time per frame,
the frame time and the device-busy share. The JAX tool timed each stage as a jitted function of its own;
here the stages run inside one ``predict_video``, as a user runs them.
Runs on the card unless ``--device cpu`` (host times only).
"""

from __future__ import annotations

import argparse

from vps_torch import zoo
from vps_torch.profile import profile_frames


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Per-stage frame time")
    ap.add_argument("--size", default="1024x2048", help="HxW")
    ap.add_argument("--iters", type=int, default=5,
                    help="steady frames profiled")
    ap.add_argument("--preset", default="half-flow", choices=zoo.PRESETS)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return profile_frames(frames=args.iters, preset=args.preset,
                          size=args.size, device=args.device)


if __name__ == "__main__":
    main()
