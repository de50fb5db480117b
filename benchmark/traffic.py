"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``benchmark/traffic/<name>.json``) holds parameters only:
its ``kind`` (``video``, ``train`` or ``images``) names the input it makes,
and the rest give sizes and counts. Everything is drawn from ``--seed`` on
the card in a few large calls, then held on the host as the program's
callers hand it over: normalised float32 frames (1, H, W, 3), and for
training the loader's batch of one.

Scenes are Cityscapes-like: wavy horizontal bands of 5 of the 11 stuff
classes and ellipses of the 8 thing classes (later ones occlude earlier
ones), coloured by the Cityscapes palette with noise. A video pans over a
scene larger than its frames; a training sample's reference frame is the
same scene one pan step away.
"""

from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_STUFF = 11
# the Cityscapes palette's first 19 classes
PALETTE = (
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32))
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
NOISE = 12.0


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of ``device`` for one purpose (``stream``) of a seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % 2 ** 63)


def _uniform(gen, n, device):
    return torch.rand(n, generator=gen, device=device)


def scene(gen, h, w, things, device):
    """(seg (h, w) int64 class map, boxes (things, 4) f32, labels (things,)
    int64 in 1..8, masks (things, h, w) bool of the visible pixels)."""
    u = _uniform(gen, 8 + 5 * things, device).cpu().tolist()
    bands = torch.randperm(NUM_STUFF, generator=gen, device=device)[:5]
    edges = sorted(int(h // 8 + v * (h - h // 8)) for v in u[:4])
    ys = torch.arange(h, device=device)[:, None].float()
    xs = torch.arange(w, device=device)[None, :].float()
    wave = (h / 40 * torch.sin(xs / (w / 25) + u[4] * 6)).long()
    edge_t = torch.tensor(edges, device=device)
    seg = bands[torch.searchsorted(edge_t, (ys.long() + wave).contiguous(),
                                   right=True)]
    boxes = torch.zeros((things, 4), device=device)
    labels = torch.zeros((things,), dtype=torch.long, device=device)
    masks = torch.zeros((things, h, w), dtype=torch.bool, device=device)
    for i in range(things):
        a, b, c, d, e = u[8 + 5 * i:13 + 5 * i]
        bw = int(w // 40 + a * (w // 6 - w // 40))
        bh = int(h // 20 + b * (h // 4 - h // 20))
        x1, y1 = int(c * (w - bw)), int(d * (h - bh))
        cx, cy = x1 + (bw - 1) / 2, y1 + (bh - 1) / 2
        inside = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1
        masks[:i] &= ~inside
        masks[i] = inside
        labels[i] = 1 + int(e * 8)
        seg = torch.where(inside, NUM_STUFF - 1 + labels[i], seg)
        boxes[i] = torch.tensor((x1, y1, x1 + bw - 1, y1 + bh - 1),
                                device=device)
    return seg, boxes, labels, masks


def render(gen, seg):
    """Normalised (1, H, W, 3) float32 image of a class map, with noise."""
    pal = torch.tensor(PALETTE, dtype=torch.float32, device=seg.device)
    mean = torch.tensor(IMG_MEAN, device=seg.device)
    std = torch.tensor(IMG_STD, device=seg.device)
    noise = torch.randn(seg.shape + (3,), generator=gen, device=seg.device)
    return ((pal[seg] + NOISE * noise - mean) / std)[None]


def videos(t: dict, seed: int, device):
    """``t['videos']`` videos of ``t['frames']`` frames of ``t['height']`` x
    ``t['width']``, as a list of float32 host arrays (frames, 1, H, W, 3).
    Each pans ``t['pan']`` = (dy, dx) pixels a frame over its scene."""
    h, w, n = t["height"], t["width"], t["frames"]
    dy, dx = t["pan"]
    gen = generator(seed, 1, device)
    out = []
    for _ in range(t["videos"]):
        seg, *_ = scene(gen, h + dy * n, w + dx * n, t["things"], device)
        frames = torch.empty((n, 1, h, w, 3), dtype=torch.float32)
        for i in range(n):
            frames[i] = render(gen, seg[dy * i:dy * i + h,
                                        dx * i:dx * i + w]).cpu()
        out.append(frames.numpy())
    return out


def images(t: dict, seed: int, device):
    """``t['images']`` images of ``t['height']`` x ``t['width']``, zero-padded
    to ``t['pad']``, as a float32 host array (n, 1, PH, PW, 3)."""
    h, w = t["height"], t["width"]
    ph, pw = t["pad"]
    gen = generator(seed, 2, device)
    out = torch.zeros((t["images"], 1, ph, pw, 3), dtype=torch.float32)
    for i in range(t["images"]):
        seg, *_ = scene(gen, h, w, t["things"], device)
        out[i, :, :h, :w] = render(gen, seg).cpu()
    return out.numpy()


def train_batches(t: dict, seed: int, device):
    """``t['batches']`` training batches of one sample at ``t['height']`` x
    ``t['width']`` with ``t['things']`` instances in ``t['max_gt']`` slots,
    each a dict of pinned host tensors with the loader's keys and shapes.
    The reference frame is the scene one pan step before or after
    (``t['ref_offsets']``)."""
    h, w, g = t["height"], t["width"], t["max_gt"]
    dy, dx = t["pan"]
    gen = generator(seed, 3, device)
    out = []
    for _ in range(t["batches"]):
        seg, boxes, labels, masks = scene(gen, h + 2 * dy, w + 2 * dx,
                                          t["things"], device)
        step = t["ref_offsets"][int(torch.randint(
            len(t["ref_offsets"]), (1,), generator=gen, device=device))]
        oy, ox = dy, dx  # the sample's crop; the reference's is one step off
        ry, rx = dy + step * dy, dx + step * dx
        crop = seg[oy:oy + h, ox:ox + w]
        k = t["things"]
        b = torch.zeros((g, 4), device=device)
        shift = torch.tensor((ox, oy, ox, oy), device=device, dtype=torch.float32)
        b[:k] = boxes - shift
        lim = torch.tensor((w - 1, h - 1, w - 1, h - 1), device=device,
                           dtype=torch.float32)
        b[:k] = torch.minimum(b[:k].clamp(min=0), lim)
        ref_b = torch.zeros((g, 4), device=device)
        ref_b[:k] = torch.minimum(
            (boxes - torch.tensor((rx, ry, rx, ry), device=device,
                                  dtype=torch.float32)).clamp(min=0), lim)
        m = torch.zeros((g, h, w), dtype=torch.uint8, device=device)
        m[:k] = masks[:, oy:oy + h, ox:ox + w]
        lab = torch.zeros((g,), dtype=torch.int32, device=device)
        lab[:k] = labels.int()
        valid = torch.arange(g, device=device) < k
        valid = valid & (m.flatten(1).amax(1) > 0)  # panned out of the crop
        batch = dict(
            img=render(gen, crop),
            ref_img=render(gen, seg[ry:ry + h, rx:rx + w]),
            gt_bboxes=torch.where(valid[:, None], b, 0)[None],
            gt_labels=torch.where(valid, lab, 0)[None],
            gt_valid=valid[None],
            gt_masks=(m * valid[:, None, None])[None],
            gt_semantic_seg=crop.int()[None],
            gt_semantic_seg_Nx=crop[::4, ::4].int().contiguous()[None],
            gt_pids=torch.where(valid, torch.arange(1, g + 1, device=device,
                                                    dtype=torch.int32), 0)[None],
            ref_bboxes=torch.where(valid[:, None], ref_b, 0)[None],
            ref_valid=valid.clone()[None])
        out.append({k2: v.cpu().pin_memory() if torch.cuda.is_available()
                    else v.cpu() for k2, v in batch.items()})
    return out


def upload(batch: dict, device) -> dict:
    """A host batch on the device, as the loader hands it over."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

