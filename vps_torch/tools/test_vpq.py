"""Video panoptic inference and the VPS artifacts (the port's counterpart of
the repo's ``tools/test_vpq.py``): every frame of every test video runs
through the detector (a video's first frame resets the track state, later
frames carry the previous frame's FPN pyramid), then the unified 3-channel
panoptic maps are built and ``pan_pred/*.png`` + ``pred.json`` written for
``vps_torch.tools.eval_vpq``.

    python -m vps_torch.tools.test_vpq CONFIG --checkpoint CKPT --out OUT.pkl
        [--preset half-flow] [--pan_im_json_file GT.json] [--lambda 5]
        [--labeled_fid 20] [--nframes_per_video 6] [--track_cap 256]
        [--chunk 8] [--streams 0] [--show_dir D]
        [--aug] [--aug-scales 1024x512,...] [--device cuda|cpu]

Writes ``OUT_pano.pkl`` (the per-frame semantic and panoptic maps at the
frame's size, class indices and track ids, in the dataset's frame order) and
``OUT_pans_unified/``. Runs on the card unless ``--device cpu``, under
``inference_policy`` (TF32 off, cuDNN deterministic): two runs write the
same bytes. ``--chunk N`` (default 8) runs N frames per ``predict_video``
call, whole videos round-robined over ``--streams`` streams
(``run_video_streams``; 0 = one per card); ``--chunk 1`` is the per-frame
loop. Every frame's outputs are the same either way. ``--show_dir D``
writes each frame's detections drawn on it beside its colourised panoptic
map. ``--aug`` runs test-time augmentation frame by frame: each frame and
its horizontal flip (and, with ``--aug-scales``, each extra scale and its
flip) enumerated by the dataset's ``prepare_test_aug``, packed onto one
canvas and merged by the detector's ``predict_aug``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import statistics
import time

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from vps_torch import resolve_device, zoo
from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.eval.unified import get_unified_pan_result, save_panoptic_outputs
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    make_frame_step,
    run_video_streams,
)
from vps_torch.utils.checkpoint import load_checkpoint
from vps_torch.utils.numerics import describe, inference_policy
from vps_torch.utils.visualize import draw_detections, panoptic_to_color


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True, help="output pickle path")
    p.add_argument("--pan_im_json_file", default=None,
                   help="categories json (panoptic gt im json)")
    p.add_argument("--mode", default="val", choices=["val", "test"],
                   help="accepted for the repo tool's command lines; does "
                        "nothing")
    p.add_argument("--n_video", type=int, default=0,
                   help="accepted for the repo tool's command lines; does "
                        "nothing")
    p.add_argument("--track_cap", type=int, default=256)
    p.add_argument("--chunk", type=int, default=8,
                   help="frames per predict_video call, whole videos "
                        "round-robined over --streams (1 = the per-frame "
                        "loop)")
    p.add_argument("--streams", type=int, default=0,
                   help="parallel video streams, spread over the cards (0 = "
                        "one per card); streams on one card each get a CUDA "
                        "stream")
    p.add_argument("--show_dir", default=None,
                   help="write each frame's detections drawn on it beside "
                        "its colourised panoptic map, as DIR/<frame>.png")
    p.add_argument("--lambda", dest="lambda_", type=int, default=5,
                   help="frame subsampling stride of the annotated frames "
                        "(every 5th Cityscapes-VPS frame is labeled; 1 = "
                        "all frames)")
    p.add_argument("--labeled_fid", type=int, default=20)
    p.add_argument("--nframes_per_video", type=int, default=6)
    p.add_argument("--preset", default=None,
                   help="inference preset applied to the model cfg "
                        "(zoo.PRESETS); presets are param-free, so any "
                        "checkpoint loads unchanged")
    p.add_argument("--aug", action="store_true",
                   help="test-time augmentation: horizontal-flip variants "
                        "merged with mmdet's aug-test semantics; runs the "
                        "per-frame loop")
    p.add_argument("--aug-scales", default=None,
                   help="comma-separated extra TTA scales as WxH (e.g. "
                        "'1024x512'); the config's test scale is always "
                        "variant 0. Implies --aug")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def pack_variants(variants):
    """The TTA variants of one frame on one zero-padded canvas, each in its
    top-left corner: (imgs, ref_imgs) of shape (V, 1, Hc, Wc, 3)."""
    hc = max(v["img"].shape[0] for v in variants)
    wc = max(v["img"].shape[1] for v in variants)
    imgs = np.zeros((len(variants), 1, hc, wc, 3), np.float32)
    refs = np.zeros_like(imgs)
    for i, v in enumerate(variants):
        hh, ww = v["img"].shape[:2]
        imgs[i, 0, :hh, :ww] = v["img"]
        refs[i, 0, :hh, :ww] = v["ref_img"]
    return imgs, refs


def aug_metas_of(variants):
    """predict_aug's per-variant metas: flip, the scale over variant 0's,
    the content shape."""
    return tuple(dict(flip=v["flip"],
                      scale_ratio=v["scale_factor"] / variants[0]["scale_factor"],
                      img_shape=tuple(v["img_shape_withoutpad"]))
                 for v in variants)


def _aug_frames(det, dataset, args, device):
    """The --aug loop: yields (run, meta) frame by frame, run() returning
    the frame's outputs; a video's first frame clears the track state."""
    tta_scales = None
    if args.aug_scales:
        extra = [tuple(int(x) for x in s.split("x"))
                 for s in args.aug_scales.split(",")]
        tta_scales = [tuple(dataset.pipeline.img_scale)] + extra
    aug_metas, carry = None, {}
    for idx in range(len(dataset)):
        variants, meta = dataset.prepare_test_aug(idx, flip=True,
                                                  scales=tta_scales)
        metas = aug_metas_of(variants)
        if aug_metas is None:
            aug_metas = metas
        elif metas != aug_metas:
            raise ValueError(f"aug meta changed mid-run (frame {idx}): "
                             f"{metas} != {aug_metas}; every frame must "
                             f"have the first frame's raw size")
        if not carry or meta["is_first"]:
            carry["state"] = empty_track_state(args.track_cap, device=device)
        imgs, refs = pack_variants(variants)

        def run(imgs=imgs, refs=refs, meta=meta):
            outputs, carry["state"] = det.predict_aug(
                torch.as_tensor(imgs, device=device),
                torch.as_tensor(refs, device=device), carry["state"],
                aug_metas,
                img_shape_withoutpad=tuple(meta["img_shape_withoutpad"]))
            return outputs

        yield run, meta


def _plain_frames(det, dataset, args):
    """The per-frame loop: yields (run, meta) frame by frame."""
    step = None
    for idx in range(len(dataset)):
        img, ref_img, meta = dataset.prepare_test(idx)
        if step is None:  # the first frame's unpadded shape, for every frame
            step = make_frame_step(
                det, track_cap=args.track_cap,
                img_shape_withoutpad=tuple(meta["img_shape_withoutpad"]))
        yield (lambda img=img, ref=ref_img, first=meta["is_first"]:
               step(img, ref, first)), meta


def _stream_frames(dataset):
    """The frames of ``run_video_streams``: (img (1, H, W, 3), is_first,
    (dataset index, meta))."""
    for idx in range(len(dataset)):
        img, _ref_img, meta = dataset.prepare_test(idx)
        yield img[None], bool(meta["is_first"]), (idx, meta)


def at_frame_size(label_map, size):
    """A label map at the frame's size (height, width), by nearest
    neighbour: the detector's maps are at the test pipeline's scale, which is
    1 for Cityscapes-VPS's 1024x2048 frames and not for VIPER's 1080x1920
    (1820x1024 at the scale (2048, 1024)); the GT is at the frame's size."""
    if label_map.shape == tuple(size):
        return label_map
    return cv2.resize(label_map, (size[1], size[0]),
                      interpolation=cv2.INTER_NEAREST)


def show_frame(dataset, shape_nopad, show_dir, out, meta):
    """The repo tool's ``show_frame`` (mmdet's ``--show``): the valid
    detections drawn on the frame, at the network's unpadded input size,
    beside the colourised panoptic id map, written as
    ``show_dir/<frame>.png``."""
    raw = cv2.imread(osp.join(dataset.img_prefix, meta["filename"]))
    h, w = shape_nopad[:2]
    frame = cv2.resize(raw, (w, h))[..., ::-1]
    valid = out["det_valid"].astype(bool)
    boxes = np.concatenate([out["det_bboxes"][valid],
                            out["det_probs"][valid, None]], -1)
    drawn = draw_detections(frame, boxes, out["det_labels"][valid],
                            class_names=getattr(dataset, "CLASSES", None))
    pan = out["panoptic_outputs"]
    # the raw map is a dense small id (a stuff class or an instance slot),
    # not cat * 1000 + inst: each id gets its own hue (divisor 1)
    pan_col = panoptic_to_color(
        (pan[0] if pan.ndim == 3 else pan).astype(np.int64), divisor=1)
    pan_col = cv2.resize(pan_col, (w, h), interpolation=cv2.INTER_NEAREST)
    name = meta["filename"].split("/")[-1].replace(".jpg", ".png")
    cv2.imwrite(osp.join(show_dir, name),
                np.concatenate([drawn, pan_col], axis=1)[..., ::-1])


def main(argv=None):
    """Returns a summary: the frame count, the wall seconds of the inference
    run (loading, predict, outputs to the host and ``--show_dir``
    drawings), the seconds of each frame after its video's first on the
    per-frame loops (predict and the copy of its outputs to the host; empty
    for the streamed run), the artifact paths and the numerics settings."""
    args = parse_args(argv)
    with inference_policy() as numerics:
        return _main(args, numerics)


def _main(args, numerics):
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.preset:
        cfg.model = zoo.preset_overrides(cfg.model, args.preset)
    det = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg, device)
    restored = load_checkpoint(args.checkpoint,
                               {"state_dict": det.state_dict()})
    det.load_state_dict(restored["state_dict"])
    dataset = build_dataset(cfg.data["test"])
    shape_nopad = tuple(dataset.prepare_test(0)[2]["img_shape_withoutpad"])
    if args.show_dir:
        os.makedirs(args.show_dir, exist_ok=True)

    aug = bool(args.aug or args.aug_scales)
    streamed = not aug and args.chunk > 1
    frames = {}  # dataset index -> the frame's entries of the pickle

    def record(out, meta):
        idx, meta = meta
        if args.show_dir:
            show_frame(dataset, shape_nopad, args.show_dir, out, meta)
        nk = int(out["num_keep"])
        info = dataset.img_infos[idx]
        size = (info["height"], info["width"])
        frames[idx] = (meta["filename"].split("/")[-1],
                       at_frame_size(out["fcn_outputs"].astype(np.uint8), size),
                       at_frame_size(out["panoptic_outputs"].astype(np.uint8),
                                     size),
                       out["panoptic_cls_inds"][:nk],
                       out["panoptic_det_obj_ids"][:nk])

    steady_s = []
    t_run = time.perf_counter()
    if streamed:
        run_video_streams(det, _stream_frames(dataset), chunk=args.chunk,
                          record=record, img_shape_withoutpad=shape_nopad,
                          track_cap=args.track_cap,
                          n_streams=args.streams or None)
    else:
        loop = (_aug_frames(det, dataset, args, device) if aug
                else _plain_frames(det, dataset, args))
        for idx, (run, meta) in enumerate(loop):
            t0 = time.perf_counter()
            out = {k: v.cpu().numpy() for k, v in run().items()}
            if not meta["is_first"]:
                steady_s.append(time.perf_counter() - t0)
            record(out, (idx, meta))
    run_s = time.perf_counter() - t_run
    if sorted(frames) != list(range(len(dataset))):
        raise RuntimeError(f"test_vpq: outputs for {len(frames)} of "
                           f"{len(dataset)} frames")

    # the dataset's frame order, whatever order the streams returned them in
    keys = ("all_names", "all_ssegs", "all_panos", "all_pano_cls_inds",
            "all_pano_obj_ids")
    results = {k: [frames[i][j] for i in sorted(frames)]
               for j, k in enumerate(keys)}
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    pkl = args.out.replace(".pkl", "_pano.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(results, f, protocol=2)

    pano_cfg = cfg.test_cfg.get("panoptic", {})
    stuff_area = pano_cfg.get("stuff_area_limit", 4 * 64 * 64)
    pcfg = cfg.model.get("panoptic", {})
    num_stuff = pcfg.get("num_classes", 19) - pcfg.get("num_things_classes", 8)
    pred_pans_2ch = get_unified_pan_result(
        results["all_ssegs"], results["all_panos"],
        results["all_pano_cls_inds"], results["all_pano_obj_ids"],
        names=results["all_names"], stuff_area_limit=stuff_area,
        num_stuff=num_stuff,
    )
    if args.pan_im_json_file:
        with open(args.pan_im_json_file) as f:
            categories = {c["id"]: c for c in json.load(f)["categories"]}
    else:
        categories = {
            i: dict(id=i, isthing=1 if i >= 11 else 0,
                    color=[(i * 37 + 29) % 256, (i * 91 + 7) % 256,
                           (i * 173 + 83) % 256])
            for i in range(19)
        }
    output_dir = args.out.replace(".pkl", "_pans_unified")
    os.makedirs(output_dir, exist_ok=True)
    names, _ = save_panoptic_outputs(
        pred_pans_2ch, categories, output_dir, lambda_=args.lambda_,
        labeled_fid=args.labeled_fid,
        nframes_per_video=args.nframes_per_video)
    how = (" --aug" if aug else f" --chunk {args.chunk} --streams "
           f"{args.streams}" if streamed else " --chunk 1")
    fps = (len(steady_s) / sum(steady_s)) if steady_s else float("nan")
    print(f"test_vpq{how}: {len(dataset)} frames on {device} in "
          f"{run_s:.3f}s, {len(dataset) / run_s:.3f} frames/s over the run "
          f"(loading, predict, outputs to the host)"
          + ("" if streamed else
             f"; {len(steady_s)} after a video's first at {fps:.3f} "
             f"frames/s (median "
             f"{statistics.median(steady_s) if steady_s else float('nan'):.4f}"
             f" s: predict + outputs to the host)")
          + f"; {len(names)} artifacts in {output_dir}; {describe(numerics)}")
    return dict(frames=len(dataset), run_s=run_s, steady_s=steady_s,
                pickle=pkl, aug=aug, streamed=streamed,
                output_dir=output_dir, artifacts=names, numerics=numerics)


if __name__ == "__main__":
    main()
