"""Drive vps_torch on one NVIDIA GPU (H100) and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. build    -- nvcc builds every kernel from vps_torch/csrc (sm_90a), one
                 nvcc per source, all started together; prints the build
                 times and the card (nvidia-smi).
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the shapes its path gives it (VIPER's frame size among
                 them) and ragged ones, with the tolerance stated;
                 CUDA-event medians beside the bound. The
                 correlation backward against the plain version's gradients
                 at the training shape and FlowNetC's geometry.
  3. main     -- PanopticFuseTrack at the full R-50 `half-flow` preset with
                 seeded random weights, predict_video over seeded random
                 1024x2048 frames (the first a reset); asserts finite outputs
                 of the contract shapes and the kernel launch counts;
                 prints steady-state frames/s and peak device memory. Then
                 where two predict_video runs part without the inference
                 policy ("inference determinism": the first op to differ,
                 then the same under the policy, and the ops
                 use_deterministic_algorithms flags), and the clip driven
                 twice under vps_torch.utils.numerics.inference_policy,
                 whose outputs must be bitwise equal, with the frame rate
                 with and without the policy ("main repeatable").
     window   -- the same with `panoptic.dcn_window = 4`: the semantic head's
                 12 deformable convs a frame run the windowed kernel.
     train    -- FuseTrack training at full width: R-50, f32 compute, one
                 seeded synthetic 800x1600 sample (things and stuff rendered
                 with numpy, gt padded to 100, a reference frame), batch 1,
                 `fusetrack_train_cfg`, through the port's Runner: 1 warm-up
                 and 5 timed SGD steps; prints s/step, peak memory, every
                 loss term at the first and last step; fails on a non-finite
                 loss, a skipped step, an unchanged trainable or a changed
                 frozen parameter, or a kernel that did not launch. Before
                 it, step 1's forward twice, compared point by point (where
                 the two part, the op that is not deterministic); after it,
                 one step split and profiled by vps_torch.profile.
     fuse     -- PanopticFuse (no track head) as "main": 2 correlation
                 launches a frame, object ids the running count of each
                 frame's valid dets, the track state untouched.
     track    -- PanopticTrack (no flow, no fuse neck) as "main": no
                 correlation launch, track ids that carry across frames.
     aug      -- FuseTrack predict_aug, each frame and its flip on one
                 canvas, 3 frames: 2 correlation launches a variant. Before
                 it, the card form of tests/test_aug_test.py:54 (one
                 identity variant against predict).
     ohem train -- "train" with the RCNN sampler OHEM (num 512), 1 warm-up
                 and 3 timed steps.
  4. small    -- the tiny `exact` model on a 64x128 clip on the card against
                 the same model's plain CPU path: equal detections and keep
                 sets, >= 0.999 semantic/panoptic agreement; the same with
                 `dcn_window = 4`, for PanopticFuse and PanopticTrack, with
                 the fuse neck's `refine_type='att'`, and for predict_aug
                 over 3 variants (identity, flip, half scale); then the
                 tiny model's loss terms and selection-free gradients on
                 the card against the CPU path, same weights, sampler draws
                 and discrete choices, with the RCNN sampler random and
                 OHEM.
  5. dataset  -- the user's workflow from files: the synthetic Cityscapes-VPS
                 fixture at 1024x2048 and its GT (the repo's prepare_data
                 scripts), vps_torch.tools.train on the port's
                 configs/cityscapes/fusetrack.py (R-50, f32, 4 steps),
                 tools.test_vpq at half-flow and tools.eval_vpq, in this
                 process; the train loader alone with 0 and 2 workers; fails
                 on a non-finite loss, a skipped step, a frame without an
                 artifact, VPQ outside [0, 100], the GT not scoring 100
                 against itself, or a kernel that did not launch; then
                 tools.test_vpq --aug (each frame and its flip) on the same
                 checkpoint, scored by tools.eval_vpq.
  6. viper    -- VIPER from files to VPQ: a synthetic fixture in VIPER's
                 format at 1080x1920 (tests/viper_fixture.py: 23 classes,
                 things 13..22; 1 train video of 4 frames, 2 val videos of
                 15), vps_torch.tools.train on the port's
                 configs/viper/fusetrack.py (R-50, f32, 4 steps),
                 tools.test_vpq at half-flow streamed (--chunk 4 --streams
                 2) and frame by frame (--chunk 1), VIPER's evaluator at
                 windows 1, 5, 10, 15 and tools.eval_ipq, in this process;
                 fails on a non-finite loss, a skipped step, a frame
                 without an artifact, the two test_vpq runs not byte-equal,
                 PQ outside [0, 100], the GT not scoring 100 against itself
                 at every window, or a kernel that did not launch.
  7. zoo      -- the R-CNN zoo's inference at full width, written from the
                 public mmdetection v1.0 configs (R-50 FPN, 81 classes,
                 their test_cfg word for word, seeded random weights): one
                 seeded 800x1333 image padded to 800x1344, 1 warm-up and 5
                 timed images each, for Mask R-CNN ("mask_rcnn"), Cascade
                 Mask R-CNN ("cascade_mask_rcnn"), HTC ("htc") and the
                 other six types ("zoo rpn", "zoo fast_rcnn" on the RPN's
                 proposals, "zoo faster_rcnn", "zoo double_head", "zoo
                 ms_rcnn" on a caffe-style R-50, "zoo grid_rcnn"); prints
                 images/s, peak memory, valid detections, host syncs an
                 image (and the named ranges of one profiled image), the
                 masks pasted at 800x1333 and binarised at mask_thr_binary,
                 and the config keys the port has no counterpart for; fails
                 on no valid detection, a non-finite output or a box
                 outside the image. Then each of the nine types and the HTC
                 alias at tests/test_two_stage.py's tiny shapes on the card
                 against the port's CPU path ("small zoo").
  8. zoo train -- the zoo's training at full width, the same configs with
                 their train_cfg word for word: each detector's ``loss`` on
                 the seeded image (12 seeded gt boxes, labels and masks of
                 16; HTC's semantic labels at stride 8), backward and the
                 port's Optimizer (momentum 0.9, weight decay 1e-4, clip 35,
                 lr 0.02/16), f32, TF32 off, under train_policy: 1 warm-up +
                 3 steps for Mask R-CNN, Cascade Mask R-CNN and HTC, 1 + 2
                 for the other six ("zoo train ...", Fast R-CNN on the RPN's
                 2000 proposals); prints s/step, peak memory, host syncs a
                 step, every loss term, nonfinite_skips and the named ranges
                 of one profiled step; fails on a non-finite term, a skipped
                 step, a changed frozen parameter or a port kernel launched.
                 Then the nine types and the HTC alias at the tiny shapes,
                 one step on the card against the CPU with the same
                 injected draws ("small zoo train": equal sampled slots,
                 terms within rel 1e-3, gradients within
                 SMALL_ZOO_GRAD_TOL); then "train repeatable": the
                 FuseTrack and Mask R-CNN train steps each twice from the
                 same state under train_policy, bitwise equal in every loss
                 term and parameter (else the first op to differ is named),
                 and the policy's cost a FuseTrack step.
Each path is driven with every launch count set to 0 just before it and read
just after. Then a `kernels` JSON line (corr_bf16_tc, corr_f32,
corr_backward, dcw_fused: each with the launches of its own path and
``launches_by_path``), the nvidia-smi line and, last, the result line
{"ok": true, "device": {...}}. Any failure raises: exit code != 0, no
result.
TF32 is off for matmuls and convolutions (vps_torch.utils.numerics.f32_policy,
printed first): float32 work runs in full float32, as the JAX reference
computes it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32 outside tensor cores

H, W = 1024, 2048
FRAMES = 6  # frame 0 (reset) + 5 steady-state frames
SEED = 0
SOURCES = ("correlation.cu", "deform_conv_windowed.cu")
WINDOW = 4  # panoptic.dcn_window of the windowed path
# the semantic head's deformable convs at 1024x2048, head_stride 4: a shared
# tower of (Cin, Cout) convs over the 4 FPN levels, one launch per level
DCN_LEVELS = [(H // 4 >> i, W // 4 >> i) for i in range(4)]
DCN_CONVS = [(256, 256), (256, 128), (128, 128)]
# training: the reference crop (vps_tpu/data/transforms.py), gt padded to
# max_gt, 1 warm-up + 5 timed steps; LiteFlowNetCorr's input at that crop
# (the 1/4 FPN level)
TRAIN_H, TRAIN_W, MAX_GT = 800, 1600, 100
TRAIN_STEPS = 6
# the "ohem train" path: the RCNN sampler OHEM, as mmdet's OHEM configs set
# it, 1 warm-up + 3 timed steps
OHEM = dict(type="OHEMSampler", num=512, pos_fraction=0.25)
OHEM_STEPS = 4
TRAIN_CORR = (1, TRAIN_H // 4, TRAIN_W // 4, 256)
# the "viper" phase: a synthetic fixture in VIPER's format at its frame size
# (1 train video of 4 frames, 2 val videos of 15: VIPER's largest VPQ
# window); the test scale (2048, 1024) takes the frame to 1820x1024, padded
# to 1824x1024; LiteFlowNetCorr's input is its 1/4 level
VIPER_H, VIPER_W = 1080, 1920
VIPER_TRAIN_FRAMES, VIPER_VAL_VIDEOS, VIPER_VAL_FRAMES = 4, 2, 15
VIPER_CHUNK, VIPER_STREAMS = 4, 2
VIPER_TEST = (1024, 1824)
VIPER_CORR = (1, VIPER_TEST[0] // 4, VIPER_TEST[1] // 4, 256)
# the Runner's checkpoints go to a temporary directory in here (git-ignored)
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work_dirs")
# the Cityscapes palette's first 19 classes, for rendering synthetic frames
PALETTE = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32)], np.float32)
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def flownetc_shape(h, w, flow_input_scale=0.5):
    """FlowNetC's cost-volume input for an h x w image: the flow input
    (scaled by flow_input_scale, 0.5 at the R-50 presets) padded to a
    multiple of 64, at stride 8, 256 channels."""
    fh, fw = (-(-round(n * flow_input_scale) // 64) * 8 for n in (h, w))
    return (1, fh, fw, 256)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters=25, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def correlation_bound_ms(shape, md, s2, dtype_name):
    """Least time on the card: each input read once, the output written
    once, over HBM rate vs 2*B*H*W*D^2*C flops over the dtype's peak."""
    b, h, w, c = shape
    d2 = (2 * (md // s2) + 1) ** 2
    esize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * h * w * c + b * h * w * d2) * esize
    flops = 2.0 * b * h * w * d2 * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def correlation_backward_bound_ms(shape, md, s2, dtype_name):
    """Least time on the card for both input gradients: f1, f2 and g read
    once, the two gradients written once, over the HBM rate vs
    4*B*H*W*D^2*C flops (a multiply and an add for each term of each
    gradient) over the dtype's peak."""
    b, h, w, c = shape
    d2 = (2 * (md // s2) + 1) ** 2
    esize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * b * h * w * c + b * h * w * d2) * esize
    flops = 4.0 * b * h * w * d2 * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def windowed_bound_ms(b, h, w, cin, cout, dtype_name, k=9):
    """Least time on the card for the windowed DCN at one level, the whole
    function from x: the largest of three times, each on its own unit of
    the card, as they can overlap. Bytes: x, the f32 offsets and the weight
    read once, the f32 output written once, over the HBM rate. Products:
    2 * Cin * k * Cout flops a pixel at the dtype's peak. Bilinear mix: 4
    corners x a multiply and an add = 8 f32 flops per tap and channel, over
    min(Cin, Cout) channels (mixing the samples, Cin, or the tap products,
    Cout, gives the same function), at the f32 peak."""
    esize = 2 if dtype_name == "bfloat16" else 4
    px = b * h * w
    times = {
        "bytes": (px * (cin * esize + 2 * k * 4 + cout * 4)
                  + k * cin * cout * esize) / HBM_BYTES_PER_S,
        "operations": max(2.0 * px * cin * k * cout / PEAK_FLOPS[dtype_name],
                          8.0 * px * k * min(cin, cout) / PEAK_FLOPS["float32"]),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from vps_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source
        list(pool.map(cuda_build.build, SOURCES))
    smi = nvidia_smi()
    each = ", ".join(f"{src} {cuda_build.build_seconds[src]:.2f}s"
                     for src in SOURCES)
    print(f"build: nvcc sm_90a {each} (phase {time.perf_counter() - t0:.2f}s, "
          f"in parallel); card: {smi}")
    return smi


def phase_kernels_correlation():
    """Kernel vs correlation_reference at both call sites (bf16 as on the
    half-flow main path: the tensor-core kernel; and f32: the register-tiled
    SIMT kernel), at both call sites of the f32 train path (the 800x1600
    crop) and of the f32 `exact` preset (FlowNetC at flow_input_scale 1.0),
    at VIPER's frame size (half-flow bf16 and exact f32, both call sites),
    at ragged shapes (C = 30 and 300, staged element by element; C = 512;
    stride2 3, 5 and 6; B = 3; H < md, so every displacement row is partly
    outside the map), and at FlowNetC's geometry with W = 100, not a
    multiple of either kernel's block. Tolerance: f32 atol 1e-5 + rtol 1e-5
    (summation order); bf16 one output ulp (rtol 2^-7) + atol 1e-6: products
    of bf16 values are exact in f32, so both round an f32 sum, taken in
    another order, to bf16, which can land one ulp apart."""
    import torch
    from vps_torch.ops import correlation, correlation_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sites = {
        "liteflow": ((1, H // 4, W // 4, 256), 4, 1),
        "flownetc": (flownetc_shape(H, W), 20, 2),
    }
    cases = [(name, shape, md, s2, dt) for name, (shape, md, s2) in sites.items()
             for dt in ("bfloat16", "float32")]
    cases += [("train-liteflow", TRAIN_CORR, 4, 1, "float32"),
              ("train-flownetc", flownetc_shape(TRAIN_H, TRAIN_W), 20, 2, "float32"),
              ("exact-flownetc", flownetc_shape(H, W, 1.0), 20, 2, "float32")]
    # VIPER's 1080x1920 frame at the test scale (1820x1024, padded to
    # 1824x1024): half-flow (bf16) and exact (f32) at both call sites;
    # widths 456 and 120 / 232, not multiples of 64
    cases += [("viper-liteflow", VIPER_CORR, 4, 1, "bfloat16"),
              ("viper-flownetc", flownetc_shape(*VIPER_TEST), 20, 2, "bfloat16"),
              ("viper-exact-liteflow", VIPER_CORR, 4, 1, "float32"),
              ("viper-exact-flownetc", flownetc_shape(*VIPER_TEST, 1.0), 20, 2,
               "float32")]
    cases += [("ragged", (2, 37, 53, 96), 4, 1, dt) for dt in ("bfloat16", "float32")]
    # C = 30: element-wise staging and a partial channel chunk
    cases += [("ragged", (2, 37, 53, 30), 6, 2, dt) for dt in ("bfloat16", "float32")]
    cases += [("ragged-flownetc", (1, H // 16, 100, 256), 20, 2, dt)
              for dt in ("bfloat16", "float32")]
    # C > 256 (f1 staged with every unit; C = 300 element by element) and
    # stride2 > 4 (residue groups)
    cases += [("ragged", shape, md, s2, dt)
              for shape, md, s2 in (((1, 12, 70, 300), 4, 1), ((1, 8, 40, 512), 6, 2),
                                    ((1, 10, 90, 40), 12, 5), ((2, 7, 75, 64), 20, 6))
              for dt in ("bfloat16", "float32")]
    # B = 3; H < md (every displacement row partly outside the map); stride2
    # 3; W not a multiple of the f32 kernel's 32- or 16-pixel block
    cases += [("ragged", shape, md, s2, dt)
              for shape, md, s2 in (((3, 3, 45, 64), 4, 1), ((1, 5, 70, 256), 20, 2),
                                    ((3, 9, 50, 300), 6, 3), ((1, 12, 70, 40), 80, 4))
              for dt in ("bfloat16", "float32")]
    max_err = {"bfloat16": 0.0, "float32": 0.0}
    per_frame = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    per_step = dict(per_frame)
    per_exact = dict(per_frame)  # the exact preset's f32 frame
    bounds = {"frame": [], "step": []}
    for name, shape, md, s2, dt in cases:
        dtype = getattr(torch, dt)
        f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = correlation(f1, f2, md, s2)
        want = correlation_reference(f1, f2, md, s2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        rtol, atol = (2.0 ** -7, 1e-6) if dt == "bfloat16" else (1e-5, 1e-5)
        limit = atol + rtol * want.float().abs()
        ok = bool((err <= limit).all())
        max_err[dt] = max(max_err[dt], float(err.max()))
        ms = cuda_ms(lambda: correlation(f1, f2, md, s2))
        plain = cuda_ms(lambda: correlation_reference(f1, f2, md, s2), iters=20)
        bound, by = correlation_bound_ms(shape, md, s2, dt)
        print(f"kernel correlation {name} {tuple(shape)} md={md} s2={s2} {dt}: "
              f"max_abs_err={float(err.max()):.3e} (tol {atol:g} + {rtol:g}*|ref|) "
              f"{'ok' if ok else 'FAIL'} ms={ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"ratio {ms / bound:.1f}x plain_ms={plain:.4f}")
        if not ok:
            raise AssertionError(f"correlation kernel disagrees at {name} {shape} {dt}")
        if name in sites and dt == "bfloat16":  # the half-flow main path
            per_frame["ms"] += ms
            per_frame["plain_ms"] += plain
            per_frame["bound_ms"] += bound
            bounds["frame"].append((bound, by))
        if name.startswith("train-"):
            bounds["step"].append((bound, by))
        for total, take in ((per_step, name.startswith("train-")),
                            (per_exact, dt == "float32" and name in
                             ("liteflow", "exact-flownetc"))):
            if take:
                for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
                    total[key] += v
    for what, total in (("train step", per_step), ("exact frame", per_exact)):
        print(f"kernel correlation per {what} (f32, 2 launches): "
              f"ms={total['ms']:.4f} bound_ms={total['bound_ms']:.4f} ratio "
              f"{total['ms'] / total['bound_ms']:.1f}x "
              f"plain_ms={total['plain_ms']:.4f}")
    # two entries: the bf16 route per half-flow frame (its 2 call sites),
    # the f32 route per train step (its 2 call sites at the train crop)
    return [dict(name=name, route="cuda", source="vps_torch/csrc/correlation.cu",
                 replaces="vps_tpu/ops/correlation.py:32", max_abs_err=max_err[dt],
                 bound_by=max(bounds[unit])[1], library_ms=None, **total)
            for name, dt, unit, total in (
                ("corr_bf16_tc", "bfloat16", "frame", per_frame),
                ("corr_f32", "float32", "step", per_step))]


def _windowed_case(gen, shape, cout, window, scale, dt, rounded=False):
    """One windowed-DCN case on the card: the wrapper (bf16: the fused
    gather-mix-product kernel; f32: tap products and the mix kernel) against
    deform_conv2d_windowed_reference on the same inputs, then the times.
    Tolerance, relative to the output's scale: bf16 2^-16 * max|ref| (the
    fused kernel's A tile holds the plain version's bf16-rounded samples bit
    for bit, so only the order of the f32 sum differs; these inputs show at
    most ~2^-18); f32 (TF32 off) 1e-4 * max|ref| + 1e-5 (the f32 route
    multiplies before it mixes, the plain version after)."""
    import torch
    from vps_torch.ops.deform_conv import (
        deform_conv2d_windowed, deform_conv2d_windowed_reference)

    b, h, w, cin = shape
    dtype = getattr(torch, dt)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    off = torch.randn((b, h, w, 18), generator=gen, device="cuda") * scale
    if rounded:  # integer offsets: zero-weight ceil corners past the edge
        off = off.round()
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              / float(np.sqrt(9 * cin))).to(dtype)
    args = (x, off, weight, 1, window)
    got = deform_conv2d_windowed(*args)
    want = deform_conv2d_windowed_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref_max = float(want.abs().max())
    tol = 2.0 ** -16 * ref_max if dt == "bfloat16" else 1e-4 * ref_max + 1e-5
    ms = cuda_ms(lambda: deform_conv2d_windowed(*args))
    plain = cuda_ms(lambda: deform_conv2d_windowed_reference(*args), iters=10)
    bound, by = windowed_bound_ms(b, h, w, cin, cout, dt)
    print(f"kernel deform_conv_windowed {tuple(shape)}->{cout} R={window} "
          f"offsets N(0,{scale:g}){' rounded' if rounded else ''} {dt}: "
          f"max_abs_err={err:.3e} (tol {tol:.3e}, max|ref| {ref_max:.3e}) "
          f"{'ok' if err <= tol else 'FAIL'} ms={ms:.4f} bound_ms={bound:.4f} "
          f"({by}) ratio {ms / bound:.1f}x plain_ms={plain:.4f}")
    if err > tol:
        raise AssertionError(f"windowed DCN kernel disagrees at {shape}->{cout} "
                             f"R={window} {dt}")
    return dict(err=err, ms=ms, plain_ms=plain, bound=(bound, by))


def phase_kernels_windowed():
    """Windowed DCN vs its plain version: the 12 launches of a half-flow
    frame (4 levels x 3 convs, bf16, offsets N(0, 1.5), R = 4), level 0 with
    the offsets x8 (mostly clamped to +-R), the f32 route at level 0
    (256 -> 256, no preset runs it), and ragged shapes in bf16 and f32
    at R = 4 and 2 (Cin 48 -> Cout 40, integer offsets; Cin 16 -> Cout 6,
    element-wise stores; Cin 20 -> Cout 12, element-wise corner reads).
    ms, plain_ms and bound_ms of the JSON line are per frame: sums over the
    12 launches of the whole function. The weight is cast to bf16 once, as
    the semantic head keeps it between frames."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    frame = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_by = []
    max_err = 0.0
    for cin, cout in DCN_CONVS:
        for h, w in DCN_LEVELS:
            r = _windowed_case(gen, (1, h, w, cin), cout, WINDOW, 1.5, "bfloat16")
            max_err = max(max_err, r["err"])
            for key in ("ms", "plain_ms"):
                frame[key] += r[key]
            frame["bound_ms"] += r["bound"][0]
            bound_by.append(r["bound"])
    h0, w0 = DCN_LEVELS[0]
    extra = [((1, h0, w0, cin), cout, WINDOW, 12.0, "bfloat16", False)
             for cin, cout in DCN_CONVS[:2]]
    # the f32 route (Y matmul + mix kernel) at level 0, 256 -> 256
    extra += [((1, h0, w0, 256), 256, WINDOW, 1.5, "float32", False)]
    extra += [((2, 37, 53, 48), 40, window, 1.5, dt, False)
              for window in (4, 2) for dt in ("float32", "bfloat16")]
    extra += [((2, 37, 53, 48), 40, 4, 3.0, dt, True)
              for dt in ("float32", "bfloat16")]
    extra += [((1, 9, 11, 16), 6, 4, 3.0, dt, True) for dt in ("float32", "bfloat16")]
    # Cin 20: element-wise corner reads
    extra += [((2, 13, 21, 20), 12, 4, 1.5, dt, False) for dt in ("float32", "bfloat16")]
    for case in extra:
        max_err = max(max_err, _windowed_case(gen, *case)["err"])
    print(f"kernel deform_conv_windowed per frame (12 launches, bf16, R={WINDOW}): "
          f"ms={frame['ms']:.4f} bound_ms={frame['bound_ms']:.4f} ratio "
          f"{frame['ms'] / frame['bound_ms']:.1f}x plain_ms={frame['plain_ms']:.4f}")
    return dict(name="dcw_fused", route="cuda",
                source="vps_torch/csrc/deform_conv_windowed.cu",
                replaces="vps_tpu/ops/deform_conv.py:447",
                max_abs_err=max_err, bound_by=max(bound_by)[1],
                library_ms=None, ms=frame["ms"], plain_ms=frame["plain_ms"],
                bound_ms=frame["bound_ms"])


def phase_kernels_correlation_backward():
    """Backward kernel vs correlation_backward_reference (autograd through
    the plain version): LiteFlowNetCorr at the 800x1600 training crop
    ((1, 200, 400, 256), md 4, f32 as trained, and bf16), FlowNetC's geometry
    ((1, 64, 128, 256), md 20, s2 2) and ragged shapes: B = 3 with H < md; W
    not a multiple of the 16-pixel block; C = 300 (two channel chunks, the
    second mostly zeros); D = 41; H not a multiple of the block's 4 rows, so
    its last rows fall past the map; stride2 3 and 6. Tolerance, relative
    to the largest gradient (sums of D^2 terms in another order; elementwise
    bounds fail where the terms cancel): f32 1e-5 * max|ref|; bf16 one ulp
    of the largest, 2^-7 * max|ref| (both sum in f32 and round once). The
    JSON entry's times are the f32 training shape's (one launch a step)."""
    import torch
    from vps_torch.ops import correlation_backward, correlation_backward_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [("train", TRAIN_CORR, 4, 1, dt) for dt in ("float32", "bfloat16")]
    cases += [("flownetc", flownetc_shape(H, W), 20, 2, dt)
              for dt in ("float32", "bfloat16")]
    cases += [("ragged", shape, md, s2, dt)
              for shape, md, s2 in (((2, 13, 37, 100), 4, 1), ((1, 9, 50, 36), 7, 3),
                                    ((1, 20, 30, 64), 96, 6), ((3, 3, 45, 64), 4, 1),
                                    ((1, 50, 100, 256), 4, 1), ((1, 12, 70, 300), 4, 1),
                                    ((1, 12, 70, 40), 80, 4), ((2, 61, 130, 256), 4, 1))
              for dt in ("float32", "bfloat16")]
    entry = None
    max_err = 0.0
    for name, shape, md, s2, dt in cases:
        dtype = getattr(torch, dt)
        d2 = (2 * (md // s2) + 1) ** 2
        f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape[:3] + (d2,), generator=gen, device="cuda").to(dtype)
        got = correlation_backward(g, f1, f2, md, s2)
        want = correlation_backward_reference(g, f1, f2, md, s2)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        ref_max = max(float(b.float().abs().max()) for b in want)
        rel = 2.0 ** -7 if dt == "bfloat16" else 1e-5
        ok = err <= rel * ref_max
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: correlation_backward(g, f1, f2, md, s2))
        plain = cuda_ms(lambda: correlation_backward_reference(g, f1, f2, md, s2),
                        iters=10)
        bound, by = correlation_backward_bound_ms(shape, md, s2, dt)
        print(f"kernel correlation_backward {name} {tuple(shape)} md={md} s2={s2} "
              f"{dt}: max_abs_err={err:.3e} (tol {rel:g}*max|ref|, max|ref| "
              f"{ref_max:.3e}) {'ok' if ok else 'FAIL'} ms={ms:.4f} "
              f"bound_ms={bound:.4f} ({by}) ratio {ms / bound:.1f}x "
              f"plain_ms={plain:.4f}")
        if not ok:
            raise AssertionError(f"correlation backward kernel disagrees at "
                                 f"{name} {shape} {dt}")
        if name == "train" and dt == "float32":
            entry = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
        del f1, f2, g, got, want
    print(f"kernel correlation_backward per train step (f32, 1 launch): "
          f"ms={entry['ms']:.4f} bound_ms={entry['bound_ms']:.4f} ratio "
          f"{entry['ms'] / entry['bound_ms']:.1f}x plain_ms={entry['plain_ms']:.4f}")
    return dict(name="corr_backward", route="cuda",
                source="vps_torch/csrc/correlation.cu",
                replaces="vps_tpu/ops/correlation.py:213",
                max_abs_err=max_err, library_ms=None, **entry)


def _check_outputs(out, frames, cap_det, h, w):
    import torch

    shapes = {
        "fcn_outputs": (frames, h, w), "panoptic_outputs": (frames, h, w),
        "det_bboxes": (frames, cap_det, 4), "det_probs": (frames, cap_det),
        "det_labels": (frames, cap_det), "det_valid": (frames, cap_det),
        "panoptic_cls_inds": (frames, cap_det),
        "panoptic_cls_prob": (frames, cap_det),
        "panoptic_det_obj_ids": (frames, cap_det),
        "panoptic_valid": (frames, cap_det), "num_keep": (frames,),
    }
    for key, shape in shapes.items():
        t = out[key]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{key}: non-finite values")
    if not bool(((out["fcn_outputs"] >= 0) & (out["fcn_outputs"] < 19)).all()):
        raise AssertionError("semantic labels out of range")
    pan = out["panoptic_outputs"]
    if not bool(((pan >= 0) & (pan < 11 + cap_det)).all()):
        raise AssertionError("panoptic ids out of range")


def synth_sample(rng, h, w, max_gt, n_things=12, num_stuff=11):
    """One seeded Cityscapes-VPS-like training sample, rendered with numpy:
    stuff as wavy horizontal bands of 5 of the 11 stuff classes, things as
    ellipses of the 8 thing classes in random boxes (later ones occlude
    earlier ones; each mask keeps its visible pixels), colours from the
    palette plus noise, normalised as the data pipeline does; the reference
    frame is the same scene shifted by (3, 5) pixels with fresh noise. gt is
    padded to max_gt with gt_valid; every thing is tracked (pid k + 1, its
    shifted box in ref_bboxes). Keys and shapes as the Runner's batches
    take them, without the leading batch dim."""
    ys, xs = np.mgrid[0:h, 0:w]
    bands = rng.choice(num_stuff, 5, replace=False)
    edges = np.sort(rng.randint(h // 8, h, 4))
    wave = (h / 40 * np.sin(xs / (w / 25) + rng.rand() * 6)).astype(int)
    seg = bands[np.searchsorted(edges, ys + wave, side="right")].astype(np.int32)
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    masks = np.zeros((max_gt, h, w), np.uint8)
    for i in range(n_things):
        bw, bh = rng.randint(w // 40, w // 6), rng.randint(h // 20, h // 4)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        cx, cy = x1 + (bw - 1) / 2, y1 + (bh - 1) / 2
        inside = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1
        masks[:i][:, inside] = 0
        masks[i][inside] = 1
        labels[i] = rng.randint(1, 9)
        seg[inside] = num_stuff - 1 + labels[i]
        boxes[i] = (x1, y1, x1 + bw - 1, y1 + bh - 1)
    valid = np.arange(max_gt) < n_things
    rgb = PALETTE[seg]
    img = rgb + rng.randn(h, w, 3).astype(np.float32) * 12
    ref = np.roll(rgb, (3, 5), axis=(0, 1)) + rng.randn(h, w, 3).astype(np.float32) * 12
    shift = np.array([5, 3, 5, 3], np.float32)
    ref_boxes = np.where(valid[:, None],
                         np.minimum(boxes + shift, [w - 1, h - 1, w - 1, h - 1]), 0)
    return dict(
        img=((img - IMG_MEAN) / IMG_STD)[None].astype(np.float32),
        ref_img=((ref - IMG_MEAN) / IMG_STD)[None].astype(np.float32),
        gt_bboxes=boxes, gt_labels=labels, gt_valid=valid, gt_masks=masks,
        gt_semantic_seg=seg[None], gt_semantic_seg_Nx=seg[None, ::4, ::4].copy(),
        gt_pids=np.where(valid, np.arange(1, max_gt + 1), 0).astype(np.int32),
        ref_bboxes=ref_boxes.astype(np.float32), ref_valid=valid.copy())


class SampleLoader:
    """The Runner's loader over one sample held on the device (loaded once,
    as set-up): ``steps`` identical batches of 1 an epoch."""

    def __init__(self, sample, device, steps):
        import torch
        from vps_torch.train.step import IMAGE_KEYS

        self.batch = {k: torch.as_tensor(v, device=device) if k in IMAGE_KEYS
                      else torch.as_tensor(v, device=device)[None]
                      for k, v in sample.items()}
        self.steps = steps

    def steps_per_epoch(self):
        return self.steps

    def epoch(self, e):
        for _ in range(self.steps):
            yield self.batch


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


KERNELS = ("corr_bf16_tc", "corr_f32", "corr_backward", "dcw_fused")


def _reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from vps_torch.ops import (correlation, correlation_backward,
                               deform_conv2d_windowed)

    for route in correlation.route_launches:
        correlation.route_launches[route] = 0
    correlation.launches = 0
    correlation_backward.launches = 0
    deform_conv2d_windowed.launches = 0


def _counts():
    """The launch counts since _reset_counts, by kernel."""
    from vps_torch.ops import (correlation, correlation_backward,
                               deform_conv2d_windowed)

    return dict(correlation.route_launches,
                corr_backward=correlation_backward.launches,
                dcw_fused=deform_conv2d_windowed.launches)


def _want(**counts):
    """Expected launch counts: the ones given, 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in KERNELS}


def _half_flow(kind, device, dcn_window=None):
    """The R-50 detector ``kind`` at the half-flow preset (``dcn_window``:
    the windowed semantic head), seeded random weights; returns it and the
    seconds it took."""
    from vps_torch import zoo
    from vps_torch.models.detectors import build_detector, random_init_

    t0 = time.perf_counter()
    cfg = _towers(zoo.preset_overrides(zoo.fusetrack_model_cfg(), "half-flow"),
                  kind)
    cfg["panoptic"]["dcn_window"] = dcn_window
    det = random_init_(build_detector(cfg, test_cfg=zoo.fusetrack_test_cfg(),
                                      device=device), seed=SEED)
    _sync(device)
    return det, time.perf_counter() - t0


def _drive(det, frames, device, after_first=None):
    """predict_video over ``frames``: the first a reset, then the rest with
    its carry, every launch count set to 0 just before. Returns (the
    outputs on the host, the carry, the first frame's seconds, steady
    frames/s, the launch counts, peak device bytes)."""
    import torch
    from vps_torch.models.detectors import empty_track_state, predict_video

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    first, carry = predict_video(det, frames[:1], [True],
                                 empty_track_state(256, device=device), frames[0])
    _sync(device)
    t1 = time.perf_counter()
    if after_first is not None:
        after_first()
    rest, carry = predict_video(det, frames[1:], [False] * (len(frames) - 1),
                                carry[0], carry[2], prev_feats=carry[1])
    _sync(device)
    t2 = time.perf_counter()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = {k: torch.cat([first[k], rest[k]]).cpu() for k in first}
    return out, carry, t1 - t0, (len(frames) - 1) / (t2 - t1), launches, peak


def phase_main(smi, device="cuda", h=H, w=W, dcn_window=None):
    """The R-50 half-flow path (with ``dcn_window`` set: the windowed
    semantic head). Returns the launch counts of the run."""
    import torch
    from vps_torch.models.panoptic_fpn import DeformConvWithOffset

    det, init_s = _half_flow("PanopticFuseTrack", device, dcn_window)
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(
        rng.randn(FRAMES, 1, h, w, 3).astype(np.float32)).to(device)
    cap_det = det.test_cfg["panoptic"]["max_det"]
    on_card = torch.device(device).type == "cuda"
    # the windowed kernel's weight layouts, made in the first frame
    dcns = [m for m in det.modules() if isinstance(m, DeformConvWithOffset)]
    layouts = []
    out, _, first_s, fps, launches, peak = _drive(
        det, frames, device, after_first=lambda: layouts.extend(
            getattr(m._cast, "_vps_fused_weight", None) for m in dcns))
    _check_outputs(out, FRAMES, cap_det, h, w)
    # 2 cost volumes a frame; 3 convs x 4 levels a frame when windowed
    want = _want(corr_bf16_tc=2 * FRAMES,
                 dcw_fused=12 * FRAMES if dcn_window else 0)
    if on_card and launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} over "
                             f"{FRAMES} frames")
    kept = sum(a is not None and getattr(m._cast, "_vps_fused_weight", None) is a
               for m, a in zip(dcns, layouts))
    if on_card and dcn_window and kept != len(dcns):
        raise AssertionError(f"windowed weight layouts rebuilt after frame 0: "
                             f"{len(dcns) - kept} of {len(dcns)}")
    name = "main" if dcn_window is None else "window"
    if dcn_window is None:
        _repeatable(det, frames, device, out, fps, smi)
    print(f"{name}: PanopticFuseTrack R-50 half-flow dcn_window={dcn_window} "
          f"{h}x{w} x{FRAMES} frames "
          f"(frame 0 reset), init {init_s:.1f}s, first frame {first_s:.3f}s, "
          f"steady {fps:.3f} frames/s over {FRAMES - 1} frames, "
          f"peak mem {peak / 2**30:.2f} GiB, launches {launches} "
          f"over {FRAMES} frames, "
          + (f"DCN weight layouts kept from frame 0 {kept}/{len(dcns)}, "
             if dcn_window else "")
          + f"dets/frame {out['det_valid'].sum(1).tolist()}, kept/frame "
          f"{out['num_keep'].tolist()}, TF32 off; card: {smi}")
    return launches


def _repeatable(det, frames, device, out, fps, smi):
    """The main path's repeatability: where two predict_video runs part
    (_predict_determinism, over the clip's first 3 frames), then the clip
    driven twice under ``inference_policy``, whose outputs must be bitwise
    equal, and once more without it, compared with ``out``, the main path's
    own run (without the policy); prints the steady frames/s of each run
    beside ``fps``, the main run's."""
    import torch
    from vps_torch.utils.numerics import inference_policy

    _predict_determinism(det, frames[:3])
    runs = []
    with inference_policy():
        for _ in range(2):
            o, _, _, f, _, _ = _drive(det, frames, device)
            runs.append((o, f))
    free, _, _, ffree, _, _ = _drive(det, frames, device)
    (a, fa), (b, fb) = runs
    same = [k for k in a if torch.equal(a[k], b[k])]
    same_free = [k for k in out if torch.equal(out[k], free[k])]
    print(f"main repeatable: the clip twice under inference_policy (cuDNN "
          f"deterministic, no benchmark): {len(same)} of {len(a)} outputs "
          f"bitwise equal; twice without it: {len(same_free)} of {len(out)}; "
          f"steady frames/s without the policy {fps:.3f} (the main run), "
          f"{ffree:.3f} (after); with it {fa:.3f}, {fb:.3f}; card: {smi}")
    if len(same) != len(a):
        raise AssertionError(f"main: outputs under inference_policy differ "
                             f"between two runs at "
                             f"{sorted(set(a) - set(same))}")


def _clip(n, h, w, seed):
    """n seeded random frames (n, 1, h, w, 3) that change slowly, as video
    does: each is 0.7 of the one before plus 0.3 of fresh noise."""
    rng = np.random.RandomState(seed)
    frames = rng.randn(n, 1, h, w, 3).astype(np.float32)
    for t in range(1, n):
        frames[t] = 0.7 * frames[t - 1] + 0.3 * frames[t]
    return frames


def phase_detector(smi, kind, device="cuda", h=H, w=W):
    """PanopticFuse (no track head) or PanopticTrack (no flow, no fuse neck)
    at the R-50 half-flow preset over a seeded FRAMES-frame clip (the first
    a reset), as phase_main. Fuse: 2 correlation launches a frame, each
    frame's object ids the running count of its valid detections, the
    track state untouched. Track: no correlation launch, and track ids that
    carry from frame to frame. Returns the launch counts of the run."""
    import torch

    det, init_s = _half_flow(kind, device)
    frames = torch.from_numpy(_clip(FRAMES, h, w, SEED + 8)).to(device)
    cap_det = det.test_cfg["panoptic"]["max_det"]
    on_card = torch.device(device).type == "cuda"
    out, carry, first_s, fps, launches, peak = _drive(det, frames, device)
    _check_outputs(out, FRAMES, cap_det, h, w)
    ndet = out["det_valid"].sum(1).tolist()
    ids = [set(out["panoptic_det_obj_ids"][t, :int(out["num_keep"][t])].tolist())
           for t in range(FRAMES)]
    if kind == "PanopticFuse":
        want = _want(corr_bf16_tc=2 * FRAMES)
        # the running count of valid dets: distinct, in [0, dets)
        nkeep = out["num_keep"].tolist()
        ok = all(len(i) == k and all(0 <= x < n for x in i)
                 for i, k, n in zip(ids, nkeep, ndet))
        ok &= int(carry[0].count) == 0 and not bool(carry[0].valid.any())
        check = f"object ids the running count of valid dets: {ok}"
    else:
        want = _want()
        carried = [len(ids[t] & set().union(*ids[:t])) for t in range(1, FRAMES)]
        ok = any(carried) and all(i <= set(range(int(carry[0].count)))
                                  for i in ids)
        check = (f"kept ids seen in an earlier frame, frames 1-{FRAMES - 1}: "
                 f"{carried}; track memory {int(carry[0].count)}")
    name = "fuse" if kind == "PanopticFuse" else "track"
    print(f"{name}: {kind} R-50 half-flow {h}x{w} x{FRAMES} frames (frame 0 "
          f"reset), init {init_s:.1f}s, first frame {first_s:.3f}s, steady "
          f"{fps:.3f} frames/s over {FRAMES - 1} frames, peak mem "
          f"{peak / 2**30:.2f} GiB, launches {launches} over {FRAMES} frames, "
          f"dets/frame {ndet}, kept/frame {out['num_keep'].tolist()}; {check}; "
          f"TF32 off; card: {smi}")
    if on_card and launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want}")
    if not ok:
        raise AssertionError(f"{name}: object ids fail their check ({check})")
    return launches


AUG_FRAMES = 3


def phase_aug(smi, device="cuda", h=H, w=W):
    """FuseTrack predict_aug at the R-50 half-flow preset, flip: each frame
    and its flip on one canvas, over a seeded AUG_FRAMES-frame clip (the
    first a reset), the track state carried; 2 correlation launches a
    variant. Before it, the card form of tests/test_aug_test.py:54 on frame
    0, cuDNN held to deterministic algorithms: predict_aug with the one
    identity variant gives predict's semantic map exactly, panoptic labels
    that differ only where an instance is involved (its merge re-runs NMS
    over the proposals of all levels) and equal where both are stuff, and
    detection and keep counts within 2. Returns the launch counts of the
    run."""
    import torch
    from vps_torch.models.detectors import empty_track_state

    det, init_s = _half_flow("PanopticFuseTrack", device)
    clip = torch.from_numpy(_clip(AUG_FRAMES, h, w, SEED + 9)).to(device)
    cap_det = det.test_cfg["panoptic"]["max_det"]
    on_card = torch.device(device).type == "cuda"
    metas = (dict(flip=False, scale_ratio=1.0, img_shape=(h, w)),
             dict(flip=True, scale_ratio=1.0, img_shape=(h, w)))

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        plain, _ = det.predict(clip[0], clip[0],
                               empty_track_state(256, device=device))
        one, _ = det.predict_aug(clip[:1], clip[:1],
                                 empty_track_state(256, device=device), metas[:1])
    pp, pa = plain["panoptic_outputs"], one["panoptic_outputs"]
    diff = pp != pa
    num_stuff = det.panopticFPN.num_stuff_classes
    both_stuff = (pp < num_stuff) & (pa < num_stuff)
    gate = dict(
        semantic_equal=bool(torch.equal(plain["fcn_outputs"], one["fcn_outputs"])),
        differ_only_at_instances=bool(((pp[diff] >= num_stuff)
                                       | (pa[diff] >= num_stuff)).all()),
        stuff_equal=bool(torch.equal(pp[both_stuff], pa[both_stuff])),
        dets_within_2=abs(int(plain["det_valid"].sum())
                          - int(one["det_valid"].sum())) <= 2,
        keeps_within_2=abs(int(plain["num_keep"]) - int(one["num_keep"])) <= 2)
    same_dets = bool(torch.equal(plain["det_valid"], one["det_valid"])
                     and torch.equal(plain["det_bboxes"], one["det_bboxes"]))
    print(f"aug: predict_aug with one identity variant vs predict, frame 0, "
          f"deterministic cuDNN: {gate}; dets {int(one['det_valid'].sum())} vs "
          f"{int(plain['det_valid'].sum())}, kept {int(one['num_keep'])} vs "
          f"{int(plain['num_keep'])}, detections identical {same_dets}, "
          f"panoptic agree {float((~diff).float().mean()):.5f}")
    if not all(gate.values()):
        raise AssertionError(f"aug: the identity variant fails {gate}")

    def variants(x):  # (1, h, w, 3) -> (2, 1, h, w, 3): it and its flip
        return torch.stack([x, x.flip(2)])

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = empty_track_state(256, device=device)
    outs, times = [], []
    for t in range(AUG_FRAMES):
        t0 = time.perf_counter()
        ref = clip[max(t - 1, 0)]
        out, state = det.predict_aug(variants(clip[t]), variants(ref), state,
                                     metas)
        _sync(device)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = {k: torch.stack([o[k] for o in outs]).cpu() for k in outs[0]}
    _check_outputs(out, AUG_FRAMES, cap_det, h, w)
    want = _want(corr_bf16_tc=2 * len(metas) * AUG_FRAMES)
    steady = AUG_FRAMES - 1
    print(f"aug: PanopticFuseTrack R-50 half-flow predict_aug flip ({len(metas)} "
          f"variants on one {h}x{w} canvas) x{AUG_FRAMES} frames (frame 0 "
          f"reset), init {init_s:.1f}s, first frame {times[0]:.3f}s, steady "
          f"{steady / sum(times[1:]):.3f} frames/s over {steady} frames, peak "
          f"mem {peak / 2**30:.2f} GiB, launches {launches} over {AUG_FRAMES} "
          f"frames, dets/frame {out['det_valid'].sum(1).tolist()}, kept/frame "
          f"{out['num_keep'].tolist()}, track memory {int(state.count)}; "
          f"TF32 off; card: {smi}")
    if on_card and launches != want:
        raise AssertionError(f"aug: kernel launches {launches} != {want}")
    return launches


def _losses_line(losses):
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())
                     if k not in ("lr", "time", "epoch", "iter"))


def phase_train(smi, device="cuda", h=TRAIN_H, w=TRAIN_W, depth=50,
                steps=TRAIN_STEPS, sampler=None):
    """FuseTrack training at full width (R-50, f32 compute as the trainer's
    default, fusetrack_train_cfg, batch 1) through the port's Runner over a
    synthetic sample: 1 warm-up step, then ``steps - 1`` timed ones (host
    clock around each step, ending in a synchronize). ``sampler``: the RCNN
    sampler's config in place of fusetrack_train_cfg's RandomSampler (the
    "ohem train" path); the determinism probe and the profiled step run only
    without it. Returns the launch counts of the run."""
    import torch
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_
    from vps_torch.train.runner import Runner

    cfg = zoo.f32_compute_overrides(zoo.fusetrack_model_cfg(depth))
    cfg.pop("type")
    train_cfg = zoo.fusetrack_train_cfg()
    if sampler is not None:
        train_cfg["rcnn"]["sampler"] = dict(sampler)
    name = "train" if sampler is None else "ohem train"
    t0 = time.perf_counter()
    det = random_init_(PanopticFuseTrack(
        train_cfg=train_cfg, test_cfg=zoo.fusetrack_test_cfg(),
        device=device, **cfg), seed=SEED)
    sample = synth_sample(np.random.RandomState(SEED + 4), h, w, MAX_GT)
    loader = SampleLoader(sample, device, steps)
    before = {n: p.detach().clone() for n, p in det.named_parameters()}
    _sync(device)
    init_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    probe = _determinism_probe(det, loader.batch) if sampler is None else {}
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as work:
        runner = Runner(det, loader, {}, work, total_epochs=1, log_interval=1,
                        ckpt_interval=1, seed=SEED)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        state = runner.run()
        _sync(device)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        ckpt_mb = sum(os.path.getsize(os.path.join(work, f))
                      for f in os.listdir(work)) / 2**20
    hist = runner.log_history
    timed = [r["time"] for r in hist[1:]]
    trainable = {n for n, p in det.named_parameters() if p.requires_grad}
    moved = {n for n, p in det.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    bad = [k for r in hist for k, v in r.items() if not np.isfinite(v)]
    print(f"{name}: PanopticFuseTrack R-{depth} f32 {h}x{w} batch 1 "
          f"fusetrack_train_cfg, rcnn sampler {train_cfg['rcnn']['sampler']}, "
          f"gt {int(sample['gt_valid'].sum())} of {MAX_GT}, "
          f"init {init_s:.1f}s, first step {hist[0]['time']:.3f}s, "
          f"{statistics.mean(timed):.4f} s/step over {len(timed)} steps "
          f"(min {min(timed):.4f}, max {max(timed):.4f}), peak mem "
          f"{peak / 2**30:.2f} GiB, nonfinite_skips "
          f"{int(hist[-1]['nonfinite_skips'])}, launches {launches} over "
          f"{len(hist)} steps, trainable changed {len(moved & trainable)}/"
          f"{len(trainable)}, frozen changed {len(moved - trainable)}/"
          f"{len(before) - len(trainable)}, checkpoint {ckpt_mb:.0f} MiB; "
          f"card: {smi}")
    print(f"{name}: step 1 {_losses_line(hist[0])}")
    print(f"{name}: step {len(hist)} {_losses_line(hist[-1])}")
    if bad:
        raise AssertionError(f"{name}: non-finite {sorted(set(bad))}")
    if state.optimizer.total_notfinite or state.optimizer.count != steps:
        raise AssertionError(f"{name}: {state.optimizer.total_notfinite} steps "
                             f"skipped, {state.optimizer.count} applied")
    if moved != trainable:
        raise AssertionError(f"{name}: unchanged trainable "
                             f"{sorted(trainable - moved)[:5]}, changed frozen "
                             f"{sorted(moved - trainable)[:5]}")
    want = _want(corr_f32=2 * steps, corr_backward=steps)
    if on_card and launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want}")
    if sampler is not None:
        return launches
    same = [k for k in probe if k in hist[0] and hist[0][k] == probe[k]]
    print(f"train determinism: the Runner's step 1 equals the probe's forward "
          f"in {len(same)} of {len(probe)} terms")
    if on_card:
        from vps_torch.profile import train_step
        train_step(det, loader.batch, state.optimizer,
                   torch.Generator(device=device).manual_seed(SEED))
    return launches


DATASET_CONFIG = """
_base_ = r"{base}"
data = dict(
    train=dict(times=1, dataset=dict(
        ann_file=r"{train_ann}", img_prefix=r"{train_img}",
        ref_prefix=r"{train_img}", seg_prefix=r"{train_seg}",
        ref_ann_file=r"{train_ann}")),
    test=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
              ref_prefix=r"{val_img}", nframes_span_test={frames}),
)
log_config = dict(interval=1)
total_epochs = 1
"""
# the CPU rehearsal's model and pipelines: the tiny model at the frame size
DATASET_TINY = """
from vps_torch import zoo
model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()
data["train"]["dataset"]["pipeline"] = dict(
    img_scale=({w}, {h}), ratio_range=(1.0, 1.0), crop_size=({h}, {w}),
    max_gt=8)
data["test"]["pipeline"] = dict(img_scale=({w}, {h}))
"""


def _run_script(cmd, cwd):
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} failed (rc {r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-2000:]}")


def _loader_seconds(cfg_path):
    """The config's train loader alone, the run's seed, with 0 workers and
    with the config's workers: host seconds until each batch of an epoch."""
    from vps_torch.config import Config
    from vps_torch.data import build_dataset, build_loader

    cfg = Config.fromfile(cfg_path)
    out = {}
    for workers in sorted({0, cfg.data.get("workers_per_gpu", 2)}):
        loader = build_loader(build_dataset(cfg.data["train"]), 1, seed=0,
                              num_workers=workers)
        times = []
        try:
            t0 = time.perf_counter()
            for _ in loader.epoch(0):
                times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        finally:
            loader.close()
        out[workers] = times
    return out


def phase_dataset(smi, numerics, device="cuda", h=H, w=W, tiny=False):
    """The user's workflow from a dataset on disk, through the port's entry
    points in this process: the synthetic Cityscapes-VPS fixture
    (``vps_torch.data.synth``: 1 train video of 4 frames, 2 val videos of 4
    frames, h x w), the val GT through the repo's prepare_data scripts, then
    ``vps_torch.tools.train`` on the port's configs/cityscapes/fusetrack.py
    (R-50, f32, the config's own pipelines; data paths, 1 epoch of 4 steps
    and a log line a step overridden), ``vps_torch.tools.test_vpq`` on its
    checkpoint at ``half-flow`` and ``vps_torch.tools.eval_vpq``; and
    eval_vpq with the GT itself as the submission, which must read 100;
    then ``test_vpq --aug`` (each frame and its flip) on the same checkpoint,
    scored by eval_vpq. ``tiny``: the tiny model and pipelines at h x w, for
    a CPU rehearsal. Returns the launch counts of the train, test and aug
    runs by path."""
    import torch
    from vps_torch.data.synth import make_synth_vps
    from vps_torch.tools import eval_vpq, test_vpq, train
    from vps_torch.utils.checkpoint import latest_checkpoint
    from vps_torch.utils.numerics import describe

    on_card = torch.device(device).type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    # 4 frames a val video: VPQ's largest window, which 3 would leave empty
    train_frames, val_videos, val_frames = 4, 2, 4
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as tmp:
        t0 = time.perf_counter()
        fix = os.path.join(tmp, "fixture")
        train_ann, train_img, train_seg = make_synth_vps(
            fix, mode="train", n_videos=1, n_frames=train_frames, H=h, W=w,
            seed=SEED, first_video=101)
        val_ann, val_img, _ = make_synth_vps(
            fix, mode="val", n_videos=val_videos, n_frames=val_frames, H=h,
            W=w, seed=SEED + 1)
        prep = os.path.join(repo, "prepare_data")
        for script in ("create_panoptic_labels.py",
                       "create_panoptic_video_labels.py"):
            _run_script([sys.executable, os.path.join(prep, script),
                         "--mode", "val", "--root_dir", fix], prep)
        gt_json = os.path.join(fix, "panoptic_gt_val_city_vps.json")
        truth_dir = os.path.join(fix, "val", "panoptic_video")
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(DATASET_CONFIG.format(
                base=os.path.join(repo, "vps_torch", "configs", "cityscapes",
                                  "fusetrack.py"),
                train_ann=train_ann, train_img=train_img, train_seg=train_seg,
                val_ann=val_ann, val_img=val_img, frames=val_frames))
            if tiny:
                f.write(DATASET_TINY.format(h=h, w=w))
        fixture_s = time.perf_counter() - t0

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        runner = train.main([cfg_path, "--work_dir", os.path.join(tmp, "work"),
                             "--device", device])
        _sync(device)
        train_s = time.perf_counter() - t0
        train_launches = _counts()
        train_peak = torch.cuda.max_memory_allocated() if on_card else 0
        hist = runner.log_history
        del runner
        loader_s = _loader_seconds(cfg_path)
        if len(hist) != train_frames:
            raise AssertionError(f"dataset: {len(hist)} logged steps, want "
                                 f"{train_frames}")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        ckpt = latest_checkpoint(os.path.join(tmp, "work"))
        test_args = [cfg_path, "--checkpoint", ckpt, "--preset", "half-flow",
                     "--lambda", "1", "--labeled_fid", "0",
                     "--nframes_per_video", str(val_frames),
                     "--pan_im_json_file", gt_json, "--chunk", "1",
                     "--device", device]
        _reset_counts()
        summary = test_vpq.main(test_args + [
            "--out", os.path.join(tmp, "out", "val.pkl")])
        _sync(device)
        test_launches = _counts()
        test_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        aug = test_vpq.main(test_args + [
            "--out", os.path.join(tmp, "aug", "val.pkl"), "--aug"])
        _sync(device)
        aug_launches = _counts()
        aug_peak = torch.cuda.max_memory_allocated() if on_card else 0

        with open(val_ann) as f:
            want_arts = sorted(im["file_name"].replace("_newImg8bit", "")
                               for im in json.load(f)["images"])
        written, vpq = {}, {}
        for key, run in (("test", summary), ("aug", aug)):
            pan_dir = os.path.join(run["output_dir"], "pan_pred")
            written[key] = sorted(n for n in os.listdir(pan_dir)
                                  if os.path.getsize(os.path.join(pan_dir, n)))
            vpq[key] = eval_vpq.main([
                "--submit_dir", run["output_dir"], "--truth_dir", truth_dir,
                "--pan_gt_json_file", gt_json, "--nframes_per_video",
                str(val_frames)])
        # the GT itself as the submission: its pngs and its json, each png
        # under the name of the image eval_vpq pairs it with (the images in
        # the json's order, the GT files sorted)
        gt_sub = os.path.join(tmp, "gt_submission")
        os.makedirs(os.path.join(gt_sub, "pan_pred"))
        with open(gt_json) as f:
            gt = json.load(f)
        for im, name in zip(gt["images"], sorted(os.listdir(truth_dir))):
            shutil.copy(os.path.join(truth_dir, name),
                        os.path.join(gt_sub, "pan_pred", im["id"] + ".png"))
        with open(os.path.join(gt_sub, "pred.json"), "w") as f:
            json.dump({"annotations": gt["annotations"]}, f)
        gt_vpq = eval_vpq.main([
            "--submit_dir", gt_sub, "--truth_dir", truth_dir,
            "--pan_gt_json_file", gt_json, "--nframes_per_video",
            str(val_frames)])

    n_val = val_videos * val_frames
    steps = [r["time"] for r in hist[1:]]
    bad = [k for r in hist for k, v in r.items() if not np.isfinite(v)]
    skips = int(hist[-1]["nonfinite_skips"])
    print(f"dataset: {describe(numerics)}")
    print(f"dataset: fixture {h}x{w} (1 train video x {train_frames} frames, "
          f"{val_videos} val videos x {val_frames}) and GT in {fixture_s:.1f}s; "
          f"train {'tiny' if tiny else 'R-50'} f32 {len(hist)} steps in "
          f"{train_s:.1f}s, first step {hist[0]['time']:.3f}s, "
          f"{statistics.mean(steps):.4f} s/step over steps 2-{len(hist)} "
          f"({', '.join(f'{t:.4f}' for t in steps)}), peak mem "
          f"{train_peak / 2**30:.2f} GiB, nonfinite_skips {skips}, launches "
          f"{train_launches}; card: {smi}")
    print(f"dataset: train loss step 1 {hist[0]['loss']:.4f}, step "
          f"{len(hist)} {hist[-1]['loss']:.4f}")
    print("dataset: the train loader alone, s a batch of 1: " + "; ".join(
        f"{w} workers " + ", ".join(f"{t:.3f}" for t in ts)
        for w, ts in loader_s.items()))
    for key, run, launches, peak in (("", summary, test_launches, test_peak),
                                     (" --aug", aug, aug_launches, aug_peak)):
        steady = run["steady_s"]
        v = vpq["aug" if key else "test"]
        print(f"dataset: test_vpq{key} half-flow {run['frames']} frames, "
              f"{len(steady) / sum(steady):.3f} frames/s over the {len(steady)} "
              f"after each video's first (predict + outputs to the host), peak "
              f"mem {peak / 2**30:.2f} GiB, launches {launches}, "
              f"{len(run['artifacts'])} artifacts of {n_val} frames; eval_vpq "
              f"vpq_all {v[0]:.4f} vpq_thing {v[1]:.4f} vpq_stuff {v[2]:.4f}; "
              f"card: {smi}")
    print(f"dataset: VPQ after {len(hist)} steps from random weights is a "
          f"check of the chain, not a quality number; the GT as its own "
          f"submission: vpq_all {gt_vpq[0]:.4f}")
    if bad:
        raise AssertionError(f"dataset: non-finite {sorted(set(bad))}")
    if skips != 0:
        raise AssertionError(f"dataset: {skips} steps skipped")
    for key, run in (("test", summary), ("aug", aug)):
        if sorted(run["artifacts"]) != want_arts or written[key] != want_arts:
            raise AssertionError(f"dataset {key}: artifacts "
                                 f"{sorted(run['artifacts'])}, written "
                                 f"{written[key]}, want one for each of "
                                 f"{want_arts}")
        if not all(0.0 <= v <= 100.0 for v in vpq[key]):
            raise AssertionError(f"dataset {key}: VPQ {vpq[key]} outside "
                                 f"[0, 100]")
    if abs(gt_vpq[0] - 100.0) > 1e-6:
        raise AssertionError(f"dataset: the GT scores {gt_vpq} against "
                             f"itself, not 100")
    got = {"dataset train": train_launches, "dataset test_vpq": test_launches,
           "dataset test_vpq --aug": aug_launches}
    want = {"dataset train": _want(corr_f32=2 * train_frames,
                                   corr_backward=train_frames),
            "dataset test_vpq": _want(corr_bf16_tc=2 * n_val),
            # 2 variants a frame (it and its flip), 2 cost volumes each
            "dataset test_vpq --aug": _want(corr_bf16_tc=4 * n_val)}
    if on_card and got != want:
        raise AssertionError(f"dataset: kernel launches {got}, want {want}")
    return got


VIPER_CONFIG = """
_base_ = r"{base}"
data = dict(
    workers_per_gpu=0,
    train=dict(ann_file=r"{train_ann}", img_prefix=r"{train_img}",
               ref_prefix=r"{train_img}", seg_prefix=r"{train_seg}",
               ref_ann_file=r"{train_ann}"),
    test=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
              ref_prefix=r"{val_img}", nframes_span_test={frames}),
)
log_config = dict(interval=1)
total_epochs = 1
"""
# the CPU rehearsal's model and pipelines: the tiny model with VIPER's heads
VIPER_TINY = """
from vps_torch import zoo
model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
model["panoptic"].update(num_things_classes=10, num_classes=23)
model["bbox_head"]["num_classes"] = 11
model["mask_head"]["num_classes"] = 11
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()
data["train"]["pipeline"] = dict(img_scale=({w}, {h}), crop_size=({ch}, {cw}),
                                 max_gt=8)
data["test"]["pipeline"] = dict(img_scale=({w}, {h}))
"""


def _tree_bytes(root):
    """{path under root: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def phase_viper(smi, device="cuda", h=VIPER_H, w=VIPER_W,
                val_frames=VIPER_VAL_FRAMES, tiny=False):
    """VIPER from files to VPQ, through the port's entry points in this
    process: a synthetic fixture in VIPER's format (tests/viper_fixture.py:
    23 classes, things 13..22, instance and panoptic GT json, colour PNGs;
    1 train video of 4 frames, 2 val videos of ``val_frames``) at h x w;
    ``vps_torch.tools.train`` on the port's configs/viper/fusetrack.py
    (R-50, f32, the loader in this process, 1 epoch of 4 steps);
    ``tools.test_vpq`` at half-flow streamed (``--chunk 4 --streams 2``) and
    frame by frame (``--chunk 1``), whose pickles and artifacts must be
    byte-equal; VIPER's evaluator (``evaluate_panoptic_from_files``) on the
    pickle's unified maps at windows {1, 5, 10, 15} (those that fit in a
    video) and on the GT against itself, which must score 100 at each; and
    ``tools.eval_ipq``. ``tiny``: the tiny model and pipelines at h x w, for
    a CPU rehearsal. Returns the launch counts of the train and test runs by
    path."""
    import cv2
    import torch
    from vps_torch.config import Config
    from vps_torch.eval.unified import get_unified_pan_result
    from vps_torch.eval.viper import (VIPER_WINDOWS,
                                      evaluate_panoptic_from_files,
                                      viper_vpq_compute)
    from vps_torch.tools import eval_ipq, test_vpq, train
    from vps_torch.utils.checkpoint import latest_checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from viper_fixture import make_viper_fixture

    on_card = torch.device(device).type == "cuda"
    windows = tuple(nf for nf in VIPER_WINDOWS if nf <= val_frames)
    n_val = VIPER_VAL_VIDEOS * val_frames
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as tmp:
        t0 = time.perf_counter()
        fix = make_viper_fixture(
            os.path.join(tmp, "viper_vps"), train_frames=VIPER_TRAIN_FRAMES,
            val_videos=VIPER_VAL_VIDEOS, val_frames=val_frames, h=h, w=w,
            seed=SEED)
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(VIPER_CONFIG.format(
                base=os.path.join(repo, "vps_torch", "configs", "viper",
                                  "fusetrack.py"),
                frames=val_frames, **{k: v for k, v in fix.items()
                                      if k not in ("gt_json", "gt_dir")}))
            if tiny:
                f.write(VIPER_TINY.format(h=h, w=w, ch=h * 3 // 4,
                                          cw=w * 3 // 4))
        fixture_s = time.perf_counter() - t0
        cfg = Config.fromfile(cfg_path)

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        runner = train.main([cfg_path, "--work_dir", os.path.join(tmp, "work"),
                             "--device", device])
        _sync(device)
        train_s = time.perf_counter() - t0
        train_launches = _counts()
        train_peak = torch.cuda.max_memory_allocated() if on_card else 0
        hist = runner.log_history
        del runner
        ckpt = latest_checkpoint(os.path.join(tmp, "work"))

        common = [cfg_path, "--checkpoint", ckpt, "--preset", "half-flow",
                  "--lambda", "1", "--labeled_fid", "0",
                  "--nframes_per_video", str(val_frames),
                  "--pan_im_json_file", fix["gt_json"], "--device", device]
        runs = {}
        for key, extra in (("streams", ["--chunk", str(VIPER_CHUNK),
                                        "--streams", str(VIPER_STREAMS)]),
                           ("frames", ["--chunk", "1"])):
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            summary = test_vpq.main(common + extra + [
                "--out", os.path.join(tmp, key, "val.pkl")])
            _sync(device)
            runs[key] = (summary, _counts(),
                         torch.cuda.max_memory_allocated() if on_card else 0,
                         _tree_bytes(os.path.join(tmp, key)))
        a, b = runs["streams"][3], runs["frames"][3]
        unequal = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        summary = runs["frames"][0]
        with open(summary["pickle"], "rb") as f:
            results = pickle.load(f)
        with open(fix["gt_json"]) as f:
            gt = json.load(f)
        want_arts = sorted(im["file_name"] for im in gt["images"])
        pan_dir = os.path.join(summary["output_dir"], "pan_pred")
        written = sorted(n for n in os.listdir(pan_dir)
                         if os.path.getsize(os.path.join(pan_dir, n)))

        # VIPER's scoring: the pickle's unified maps, in the GT's order
        t0 = time.perf_counter()
        pcfg = cfg.model["panoptic"]
        pans_2ch = get_unified_pan_result(
            results["all_ssegs"], results["all_panos"],
            results["all_pano_cls_inds"], results["all_pano_obj_ids"],
            names=results["all_names"],
            stuff_area_limit=cfg.test_cfg["panoptic"]["stuff_area_limit"],
            num_stuff=pcfg["num_classes"] - pcfg["num_things_classes"])
        vpq = evaluate_panoptic_from_files(
            [pans_2ch[n] for n in sorted(pans_2ch)],
            os.path.join(tmp, "viper_eval"), fix["gt_json"], fix["gt_dir"],
            n_video=VIPER_VAL_VIDEOS, windows=windows)
        eval_s = time.perf_counter() - t0
        # the GT as its own submission
        cats = {c["id"]: c for c in gt["categories"]}
        gt_frames = [(ann, ann, pan, pan) for ann, pan in (
            (ann, cv2.imread(os.path.join(fix["gt_dir"], im["file_name"]))
             [..., ::-1]) for ann, im in zip(gt["annotations"], gt["images"]))]
        videos = [gt_frames[i:i + val_frames]
                  for i in range(0, len(gt_frames), val_frames)]
        gt_pq = {nf: viper_vpq_compute(videos, cats, nf)[0]["All"]["pq"]
                 for nf in windows}
        ipq = eval_ipq.main(["--submit_dir", summary["output_dir"],
                             "--truth_dir", fix["gt_dir"],
                             "--pan_gt_json_file", fix["gt_json"]])

    steps = [r["time"] for r in hist[1:]]
    bad = [k for r in hist for k, v in r.items() if not np.isfinite(v)]
    skips = int(hist[-1]["nonfinite_skips"])
    print(f"viper: fixture {h}x{w} (1 train video x {VIPER_TRAIN_FRAMES} "
          f"frames, {VIPER_VAL_VIDEOS} val videos x {val_frames}) and GT in "
          f"{fixture_s:.1f}s; train {'tiny' if tiny else 'R-50'} f32 "
          f"{len(hist)} steps in {train_s:.1f}s, first step "
          f"{hist[0]['time']:.3f}s, {statistics.mean(steps):.4f} s/step over "
          f"steps 2-{len(hist)} ({', '.join(f'{t:.4f}' for t in steps)}; the "
          f"loader in this process), peak mem {train_peak / 2**30:.2f} GiB, "
          f"nonfinite_skips {skips}, loss step 1 {hist[0]['loss']:.4f}, step "
          f"{len(hist)} {hist[-1]['loss']:.4f}, launches {train_launches}; "
          f"card: {smi}")
    for key, (run, launches, peak, _) in runs.items():
        how = (f"--chunk {VIPER_CHUNK} --streams {VIPER_STREAMS}"
               if key == "streams" else "--chunk 1")
        steady = run["steady_s"]
        print(f"viper: test_vpq {how} half-flow {run['frames']} frames in "
              f"{run['run_s']:.3f}s: {run['frames'] / run['run_s']:.3f} "
              f"frames/s over the run (loading, predict, outputs to the host)"
              + (f", {len(steady) / sum(steady):.3f} frames/s over the "
                 f"{len(steady)} after each video's first (predict + outputs "
                 f"to the host)" if steady else "")
              + f", peak mem {peak / 2**30:.2f} GiB, launches {launches}, "
              f"{len(run['artifacts'])} artifacts of {n_val} frames; card: "
              f"{smi}")
    print(f"viper: the two test_vpq runs: {len(a)} files, "
          f"{len(a) - len(unequal)} byte-equal"
          + (f", differ: {unequal[:6]}" if unequal else ""))
    for nf in windows:
        r = vpq[nf]
        print(f"viper: window {nf:2d}: PQ all {100 * r['All']['pq']:.4f} "
              f"things {100 * r['Things']['pq']:.4f} stuff "
              f"{100 * r['Stuff']['pq']:.4f}; the GT against itself "
              f"{100 * gt_pq[nf]:.4f}")
    print(f"viper: VIPER's evaluator in {eval_s:.1f}s; eval_ipq pq_all "
          f"{ipq[0]:.4f} pq_thing {ipq[1]:.4f} pq_stuff {ipq[2]:.4f}; PQ from "
          f"random weights after {len(hist)} steps is a check of the chain, "
          f"not a quality number")
    if bad:
        raise AssertionError(f"viper: non-finite {sorted(set(bad))}")
    if skips != 0 or len(hist) != VIPER_TRAIN_FRAMES:
        raise AssertionError(f"viper: {skips} steps skipped, {len(hist)} "
                             f"logged, want {VIPER_TRAIN_FRAMES}")
    for key, (run, _, _, _) in runs.items():
        if sorted(run["artifacts"]) != want_arts or (
                key == "frames" and written != want_arts):
            raise AssertionError(f"viper {key}: artifacts "
                                 f"{sorted(run['artifacts'])}, want one for "
                                 f"each of {want_arts}")
    if len(results["all_names"]) != n_val:
        raise AssertionError(f"viper: the pickle has "
                             f"{len(results['all_names'])} frames of {n_val}")
    if unequal:
        raise AssertionError(f"viper: the streamed and per-frame test_vpq "
                             f"runs differ in {unequal[:6]}")
    pqs = [100 * vpq[nf][k]["pq"] for nf in windows
           for k in ("All", "Things", "Stuff")] + list(ipq)
    if not all(0.0 <= v <= 100.0 for v in pqs):
        raise AssertionError(f"viper: PQ outside [0, 100]: {pqs}")
    if any(abs(gt_pq[nf] - 1.0) > 1e-9 for nf in windows):
        raise AssertionError(f"viper: the GT scores {gt_pq} against itself, "
                             f"not 100")
    got = {"viper train": train_launches,
           f"viper test_vpq --chunk {VIPER_CHUNK} --streams {VIPER_STREAMS}":
           runs["streams"][1], "viper test_vpq --chunk 1": runs["frames"][1]}
    # a streamed video runs whole chunks: its last is padded
    padded = VIPER_VAL_VIDEOS * -(-val_frames // VIPER_CHUNK) * VIPER_CHUNK
    want = {"viper train": _want(corr_f32=2 * len(hist),
                                 corr_backward=len(hist)),
            f"viper test_vpq --chunk {VIPER_CHUNK} --streams {VIPER_STREAMS}":
            _want(corr_bf16_tc=2 * padded),
            "viper test_vpq --chunk 1": _want(corr_bf16_tc=2 * n_val)}
    if on_card and got != want:
        raise AssertionError(f"viper: kernel launches {got}, want {want}")
    return got


def _points(det, run, modules=None, wrapped=()):
    """Exact fingerprints of what one call of ``run(record)`` computes.
    Points: the input ("<in") and output of each of ``modules`` (name,
    module) pairs, the detector's top-level modules by default, one point
    per call and tensor; the results of the functions of
    ``vps_torch.models.detectors.panoptic`` named in ``wrapped``; and what
    ``run`` passes to ``record(name, tensors)``. A module's points are
    recorded when it returns, so a leaf's come before its parent's. A
    fingerprint sums the raw bits of a tensor as int64 with position
    weights: equal tensors give equal fingerprints, whatever the order of
    the sum. Returns ({point: fingerprint} in the order recorded, run's
    result)."""
    import torch
    import vps_torch.models.detectors.panoptic as panoptic

    points = {}
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def record(name, out):
        if isinstance(out, (tuple, list)):
            for o in out:
                record(name, o)
        elif isinstance(out, torch.Tensor):
            t = out.detach().contiguous().view(-1)
            bits = t.view(ints[t.element_size()]).long()
            w = torch.arange(bits.numel(), device=t.device) % 1000003 + 1
            key = f"{name}#{sum(k.startswith(name + '#') for k in points)}"
            points[key] = int((bits * w).sum())

    def hook(name):
        def call(m, inputs, out):
            record(name + "<in", inputs)
            record(name, out)
        return call

    hooks = [m.register_forward_hook(hook(n))
             for n, m in (modules or det.named_children())]
    originals = {f: getattr(panoptic, f) for f in wrapped}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            record(name, tuple(out))
            return out
        return call

    for name, fn in originals.items():
        setattr(panoptic, name, wrap(name, fn))
    try:
        result = run(record)
    finally:
        for h in hooks:
            h.remove()
        for name, fn in originals.items():
            setattr(panoptic, name, fn)
    return points, result


def _fingerprints(det, batch, seed, modules=None):
    """One forward of the training loss with the Runner's first draws
    (generator seeded as the Runner seeds it), through _points: every
    module of ``modules`` (default: the top-level ones), the proposals, the
    sampled RoIs and each loss term. Returns (points, total, loss terms)."""
    import torch
    from vps_torch.train.step import make_loss_fn

    def run(record):
        gen = torch.Generator(device=det.device).manual_seed(seed + 12345)
        total, log_vars = make_loss_fn(det)(batch, gen)
        for k, v in sorted(log_vars.items()):
            record(k, v)
        return total, {k: float(v.detach()) for k, v in log_vars.items()}

    points, (total, losses) = _points(det, run, modules,
                                      ("rpn_proposals", "proposal_target"))
    return points, total, losses


def _differ(modules=None, det=None, batch=None):
    """Two _fingerprints runs of step 1; the points that differ, in the
    order recorded, and the number of points."""
    a = _fingerprints(det, batch, SEED, modules)[0]
    b = _fingerprints(det, batch, SEED, modules)[0]
    return [k for k in a if a[k] != b.get(k)], len(a)


def _determinism_probe(det, batch):
    """Is step 1's forward the same twice in one process? Two forwards
    compared point by point (_fingerprints); where they part, the same
    inside the first top-level module to differ, every submodule hooked:
    the first point to differ is the op that is not deterministic (a
    module's output whose input is equal, or the input of a module when the
    op is plain code between modules); then two more forwards with cuDNN
    held to deterministic algorithms. Last, the ops that
    torch.use_deterministic_algorithms flags in one forward and backward.
    Returns step 1's loss terms; leaves no gradient behind."""
    import warnings

    import torch

    _, _, losses = _fingerprints(det, batch, SEED)
    differ, n = _differ(det=det, batch=batch)
    print(f"train determinism: two forwards of step 1 in this process: "
          f"{n - len(differ)} of {n} points bitwise equal"
          + (f", differ at {differ[:8]}" if differ else ""))
    top = differ[0].split("<")[0].split("#")[0] if differ else None
    if top in dict(det.named_children()):
        mods = [(f"{top}.{k}".rstrip("."), m)
                for k, m in det.get_submodule(top).named_modules()]
        inner, n = _differ(mods, det, batch)
        if inner:
            name = inner[0].split("<")[0].split("#")[0]
            kind = type(dict(det.named_modules()).get(name)).__name__
            print(f"train determinism: inside {top} ({n} points), the first "
                  f"to differ: {inner[0]} ({kind}); then {inner[1:4]}")
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            still, n = _differ(det=det, batch=batch)
        print(f"train determinism: with cuDNN held to deterministic "
              f"algorithms: {n - len(still)} of {n} points bitwise equal")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, total, _ = _fingerprints(det, batch, SEED)
            total.backward()
            _sync(det.device)
    finally:
        torch.use_deterministic_algorithms(False)
    for p in det.parameters():
        p.grad = None
    flagged = sorted({str(w.message).split(" does not have")[0][:80]
                      for w in caught if "deterministic" in str(w.message)})
    print(f"train determinism: ops flagged by use_deterministic_algorithms in "
          f"one forward + backward: {flagged}")
    return losses


def _predict_points(det, frames, modules=None):
    """_points of one predict_video over ``frames`` (the first a reset):
    every module of ``modules`` (default: the top-level ones), the
    proposals, and each output."""
    from vps_torch.models.detectors import empty_track_state, predict_video

    def run(record):
        out, _ = predict_video(det, frames, [True] + [False] * (len(frames) - 1),
                               empty_track_state(256, device=det.device),
                               frames[0])
        for k, v in sorted(out.items()):
            record("out:" + k, v)

    return _points(det, run, modules, ("rpn_proposals",))[0]


def _predict_determinism(det, frames):
    """Is predict_video the same twice in one process? Two runs over
    ``frames`` compared point by point without the inference policy (cuDNN
    free to choose); where they part, the same inside the first top-level
    module to differ, every submodule hooked, naming the first op that
    differs; then two runs under ``inference_policy``; last, the ops that
    torch.use_deterministic_algorithms flags in one run. Returns the points
    that differ under the policy."""
    import warnings

    import torch
    from vps_torch.utils.numerics import inference_policy

    def differ(modules=None):
        a = _predict_points(det, frames, modules)
        b = _predict_points(det, frames, modules)
        return [k for k in a if a[k] != b.get(k)], len(a)

    free, n = differ()
    print(f"inference determinism: two predict_video runs over {len(frames)} "
          f"frames, cuDNN free: {n - len(free)} of {n} points bitwise equal"
          + (f", differ at {free[:8]}" if free else ""))
    top = free[0].split("<")[0].split("#")[0] if free else None
    if top in dict(det.named_children()):
        mods = [(f"{top}.{k}".rstrip("."), m)
                for k, m in det.get_submodule(top).named_modules()]
        inner, m = differ(mods)
        if inner:
            name = inner[0].split("<")[0].split("#")[0]
            kind = type(dict(det.named_modules()).get(name)).__name__
            print(f"inference determinism: inside {top} ({m} points), the "
                  f"first to differ: {inner[0]} ({kind}); then {inner[1:4]}")
    with inference_policy():
        still, n = differ()
    print(f"inference determinism: under inference_policy (cuDNN "
          f"deterministic): {n - len(still)} of {n} points bitwise equal"
          + (f", differ at {still[:8]}" if still else ""))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _predict_points(det, frames)
            _sync(det.device)
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have")[0][:80]
                      for w in caught if "deterministic" in str(w.message)})
    print(f"inference determinism: ops flagged by use_deterministic_algorithms "
          f"in one predict_video run: {flagged}")
    return still


def _proposal_divergence(own, ref, noise):
    """Where the card's own proposals (own: boxes, scores, valid) leave the
    CPU's (ref), and whether each departure is a near-tie under ``noise``,
    the largest score difference between the devices over all anchors. Rows
    in one list only are classed by their score's distance to the list's
    last kept score (the top-k cut) and their largest IoU with the rows
    above them (NMS keeps a box below nms_thr 0.7)."""
    import torch
    from vps_torch.ops.box import bbox_overlaps

    (ob, os_, ov), (rb, rs, rv) = own, ref
    n = int(rv.sum())
    same = (ob - rb).abs().max(1).values <= 1e-3
    if bool(same[:n].all()) and torch.equal(ov, rv):
        return f"all {n} rows equal"
    diff = int((~same[:n]).sum())
    near = lambda a, b: (a[:, None, :] - b[None, :, :]).abs().max(-1).values <= 1e-3
    in_ref = near(ob[:n], rb[:n]).any(1)
    in_own = near(rb[:n], ob[:n]).any(1)
    moved = int(((~same[:n]) & in_ref).sum())
    parts = []
    for name, boxes, scores, valid, only in (("card", ob, os_, ov, ~in_ref),
                                             ("cpu", rb, rs, rv, ~in_own)):
        cut = float(scores[int(valid.sum()) - 1])
        for i in only.nonzero().flatten().tolist()[:4]:
            iou = float(bbox_overlaps(boxes[i:i + 1], boxes[:i]).max()) if i else 0.0
            parts.append(f"{name}-only row {i} score {float(scores[i]):.7f} "
                         f"(cut {cut:.7f}, gap {abs(float(scores[i]) - cut):.1e}), "
                         f"max IoU above {iou:.6f}")
    gaps = (os_[:n] - rs[:n]).abs()[~same[:n]]
    shift = float((ob[:n] - rb[:n]).abs().max(1).values[~same[:n]].max())
    return (f"{diff} of {n} rows differ by more than 1e-3 px (at most "
            f"{shift:.1e} px): {moved} reordered, largest score gap "
            f"at a differing row {float(gaps.max()):.1e} (score noise "
            f"{noise:.1e}); {int((~in_ref).sum())} card-only, "
            f"{int((~in_own).sum())} cpu-only" + "".join("; " + p for p in parts))


def _choice_divergence(own, ref):
    """Where the card would choose otherwise than the CPU at the fuse
    neck's discrete choices (each call: its kind, its input on that device
    and its choice there), and how close each such choice is to a tie: for
    a max pool, the card's value at its own pick less its value at the
    CPU's; for a leaky ReLU, |pre-activation|. Beside it, the largest
    difference between the two devices' inputs: a near-tie lies within it."""
    stats = {}
    for (kind, x, pick), (_, rx, rpick) in zip(own, ref):
        st = stats.setdefault(kind, [0, 0, 0, 0.0, 0.0])
        moved = pick != rpick
        st[0] += 1
        st[1] += pick.numel()
        st[2] += int(moved.sum())
        st[4] = max(st[4], float((x - rx).abs().max()))
        if moved.any():
            if kind == "leaky_relu":
                gap = x.abs()[moved].max()
            else:
                flat = x.flatten(2)
                gap = (flat.gather(2, pick.flatten(2))
                       - flat.gather(2, rpick.flatten(2))).max()
            st[3] = max(st[3], float(gap))
    return "; ".join(f"{kind}: {flips} of {n} over {calls} calls, largest gap "
                     f"{gap:.1e} (input noise {noise:.1e})"
                     for kind, (calls, n, flips, gap, noise) in stats.items())


def _ohem_divergence(own, ref, sampler):
    """The card's own hard-mining losses against the CPU's (both over the
    same candidates): their largest difference, the CPU selection's edge
    (the gap between the last candidate kept and the first left out, of
    the positives and of the negatives) and the slots the card's own
    losses would pick differently."""
    from vps_torch.core.sampler import ohem_sample

    gi, losses = ref
    noise = float((own[1] - losses)[gi >= 0].abs().max())
    num, pf = sampler["num"], sampler["pos_fraction"]
    n_pos = int((gi > 0).sum())
    gaps = []
    for kind, keep in ((gi > 0, int(num * pf)),
                       (gi == 0, num - min(n_pos, int(num * pf)))):
        vals = losses[kind].sort(descending=True).values
        if len(vals) > keep:
            gaps.append(float(vals[keep - 1] - vals[keep]))
    mine = set(ohem_sample(gi, own[1], num, pf).inds.tolist())
    theirs = set(ohem_sample(gi, losses, num, pf).inds.tolist())
    return (f"{int((gi >= 0).sum())} candidates, max |card - cpu| {noise:.2e}, "
            f"edge gaps {', '.join(f'{g:.2e}' for g in gaps) or 'none'}; "
            f"{len(mine - theirs)} slots the card's own losses would change")


def phase_small_train(device="cuda", sampler=None):
    """The tiny model's training loss on a 128x256 sample on the card against
    the same model's plain CPU path: same weights, the same sampler draws
    (both from one seeded CPU generator) and the same proposals (the CPU
    run's, replayed on the card; where the card's own depart from them, the
    rows are shown with their score gaps beside the score noise between the
    devices), and the fuse neck's other discrete choices: its max pools
    (TCEA's spatial attention, the balanced pyramid's adaptive pools) and
    the branch of each leaky ReLU (TCEA, LiteFlowNet), the CPU's taken on
    the card, and the card's own shown with their gaps to a tie. Every loss
    term, and the gradients of the selection-free terms
    (loss_segm, loss_rpn_cls, loss_rpn_bbox: no proposal selection between
    the weights and the loss). The weights are those of
    tests/test_torch_port_train.py: DCN offsets near 0.5 and LiteFlowNet's
    residual flow near 0, so no trained bilinear sample sits within
    rounding of an integer, where its gradient jumps. ``sampler``: the RCNN
    sampler's config (OHEM): its ranking is a discrete choice too, the
    CPU's hard-mining losses ranked on the card, the card's own shown beside
    them with the selection's edge."""
    import torch
    import torch.nn.functional as F
    import vps_torch.core.sampler as samplers
    import vps_torch.core.targets as targets
    import vps_torch.models.bfp_tcea as bfp_tcea
    import vps_torch.models.detectors.panoptic as panoptic
    import vps_torch.models.flow.liteflow as liteflow
    import vps_torch.models.flow.tcea as tcea
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_
    from vps_torch.ops import correlation_backward

    cfg = zoo.f32_compute_overrides(zoo.tiny_overrides(zoo.fusetrack_model_cfg()))
    cfg.pop("type")
    train_cfg = zoo.tiny_train_cfg()
    if sampler is not None:
        train_cfg["rcnn"]["sampler"] = dict(sampler)
    name = "small train" if sampler is None else "small ohem train"
    kw = dict(train_cfg=train_cfg, test_cfg=zoo.fusetrack_test_cfg(), **cfg)
    cpu = random_init_(PanopticFuseTrack(device="cpu", **kw), 1)
    with torch.no_grad():
        cpu.bbox_head.fc_cls.weight.mul_(0.25)  # the milder classifier of
        cpu.bbox_head.fc_cls.bias.mul_(0.25)    # phase_small
        for n, p in cpu.named_parameters():
            if n.startswith("panopticFPN.") and ".conv_offset." in n:
                p.mul_(0.05) if n.endswith("weight") else p.fill_(0.5)
            elif n == "extra_neck.liteflownet.flow_estimator.convs.3.weight":
                p.mul_(0.01)
    gpu = PanopticFuseTrack(device=device, **kw)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    sample = synth_sample(np.random.RandomState(SEED + 5), 128, 256, 8, n_things=4)
    free = ("loss_segm", "loss_rpn_cls", "loss_rpn_bbox")
    proposals, scores, picks, hard = {}, {}, {}, {}

    def replayed(dev, kind, plain, choose, apply):
        """``plain``, recording each call's input and discrete choice; on
        the card, the output for the CPU's choice in the same call (the
        gradient then takes the CPU's route)."""
        def call(x, *args):
            pick = choose(x, *args)
            if pick is None:  # nothing to choose
                return plain(x, *args)
            calls = picks[dev]
            calls.append((kind, x.detach().cpu(), pick.cpu()))
            if dev == "cpu":
                return plain(x, *args)
            return apply(x, picks["cpu"][len(calls) - 1][2].to(x.device))
        return call

    def gather(x, idx):  # a max pool's output for the flat indices idx
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    def adaptive_pick(x, size):
        if tuple(size) == tuple(x.shape[-2:]):
            return None
        return F.adaptive_max_pool2d(x, tuple(size), return_indices=True)[1]

    def patches(dev):
        """(module, name, replacement) for each discrete choice replayed."""
        return [
            (tcea, "max_pool", replayed(
                dev, "max_pool", tcea.max_pool,
                lambda x, k, st, p: F.max_pool2d(x, k, st, p,
                                                 return_indices=True)[1],
                gather)),
            (bfp_tcea, "adaptive_max_pool", replayed(
                dev, "adaptive_max_pool", bfp_tcea.adaptive_max_pool,
                adaptive_pick, gather))] + [
            (mod, "leaky_relu", replayed(
                dev, "leaky_relu", mod.leaky_relu, lambda x: x > 0,
                lambda x, pos: torch.where(pos, x, x * 0.1)))
            for mod in (tcea, liteflow)]

    def run(det, dev):
        det.zero_grad(set_to_none=True)
        picks[dev] = []
        gen = torch.Generator().manual_seed(SEED + 6)

        def props(cls_outs, *args, **kwargs):
            own = rpn_proposals(cls_outs, *args, **kwargs)
            proposals[dev] = [t.cpu() for t in own]
            scores[dev] = torch.cat([c.reshape(-1) for c in cls_outs]).sigmoid().cpu()
            return tuple(t.to(dev) for t in proposals["cpu"])

        def ohem(gi, losses, num, pos_fraction):
            hard[dev] = (gi.cpu(), losses.cpu())
            return ohem_sample(gi, hard["cpu"][1].to(losses.device), num,
                               pos_fraction)

        rpn_proposals = panoptic.rpn_proposals
        ohem_sample = targets.ohem_sample
        patched = [(samplers, "uniform",
                    lambda g, shape, d: torch.rand(shape, generator=gen).to(d)),
                   (panoptic, "rpn_proposals", props),
                   (targets, "ohem_sample", ohem)] + patches(dev)
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        try:
            losses = det.loss(**{k: torch.as_tensor(v, device=dev)
                                 for k, v in sample.items()})
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        sum(losses[k] for k in free).backward()
        grads = {n: p.grad.cpu() for n, p in det.named_parameters()
                 if p.grad is not None}
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    want, want_g = run(cpu, "cpu")
    correlation_backward.launches = 0
    got, got_g = run(gpu, device)
    if torch.device(device).type == "cuda" and correlation_backward.launches != 1:
        raise AssertionError(f"{name}: the backward kernel did not launch")
    noise = float((scores[device] - scores["cpu"]).abs().max())
    fails, parts = [], []
    for k in sorted(want):  # relative; the selection-free terms and loss_pano
        rel = 1e-4 if k in free + ("loss_pano",) else 1e-3  # (gt boxes) tighter
        err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
        parts.append(f"{k} {got[k]:.5f}/{want[k]:.5f} rel {err:.1e} (tol {rel:g})")
        if not err <= rel:
            fails.append(k)
    # per tensor, within 5e-3 of its largest CPU gradient plus 1e-6 of the
    # largest over all tensors (f32 sums in other orders), as the CPU test
    # holds the port to jax.grad
    if set(got_g) != set(want_g):
        fails.append("gradient set")
    gmax = max(float(g.abs().max()) for g in want_g.values())

    def ratios(grads):
        return {n: float((grads[n] - g).abs().max())
                / (5e-3 * float(g.abs().max()) + 1e-6 * gmax)
                for n, g in want_g.items() if n in grads}

    r = ratios(got_g)
    worst = max((v, n) for n, v in r.items())
    fails += [n for n, v in r.items() if not v <= 1.0]
    print(f"{name}: tiny f32 128x256 card vs cpu, same draws, the cpu's "
          f"proposals: " + "; ".join(parts))
    print(f"{name}: the card's own proposals vs the cpu's: "
          + _proposal_divergence(proposals[device], proposals["cpu"], noise))
    print(f"{name}: the card's own choices in the fuse neck vs the "
          f"cpu's: " + _choice_divergence(picks[device], picks["cpu"]))
    if sampler is not None:
        print(f"{name}: the card's own OHEM ranking vs the cpu's: "
              + _ohem_divergence(hard[device], hard["cpu"], sampler))
    print(f"{name}: selection-free gradients of {len(want_g)} tensors, "
          f"max |card - cpu| within (5e-3 max|cpu| + 1e-6 max over all), worst "
          f"at {worst[0]:.3f} of its limit ({worst[1]})")
    if fails:
        raise AssertionError(f"{name}: card and cpu disagree at {fails[:5]}")


def _towers(cfg, kind):
    """A model config for the detector ``kind``: PanopticFuse without the
    track head, PanopticTrack without the fuse neck."""
    cfg = dict(cfg, type=kind)
    if kind == "PanopticFuse":
        cfg["track_head"] = None
    elif kind == "PanopticTrack":
        cfg["extra_neck"] = None
    return cfg


def _small_pair(device, kind="PanopticFuseTrack", dcn_window=None,
                refine_type="conv"):
    """The tiny exact-preset model (R-18, TinyFlow) on the CPU, seeded, and
    a copy of it on ``device``."""
    import torch
    from vps_torch import zoo
    from vps_torch.models.detectors import build_detector, random_init_

    cfg = _towers(zoo.exact_overrides(zoo.tiny_overrides(
        zoo.fusetrack_model_cfg())), kind)
    cfg["panoptic"]["dcn_window"] = dcn_window
    if cfg["extra_neck"] is not None:
        cfg["extra_neck"]["refine_type"] = refine_type
    tcfg = zoo.fusetrack_test_cfg()
    tcfg["rpn"].update(nms_pre=128, max_num=64)
    tcfg["panoptic"].update(score_thresh=0.2, max_det=12)
    cpu = random_init_(build_detector(cfg, test_cfg=tcfg, device="cpu"), 1)
    # a milder classifier than random_init_'s: probabilities that saturate to
    # 1.0 in f32 tie, and ulp-level differences between the two devices then
    # reorder the detections
    with torch.no_grad():
        cpu.bbox_head.fc_cls.weight.mul_(0.25)
        cpu.bbox_head.fc_cls.bias.mul_(0.25)
    gpu = build_detector(cfg, test_cfg=tcfg, device=device)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def _small_gates(label, got, want):
    """Card against CPU: equal detections, keep sets and ids, boxes within
    2e-2, >= 0.999 semantic and panoptic agreement."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    for k in ("det_valid", "det_labels", "num_keep", "panoptic_valid",
              "panoptic_cls_inds", "panoptic_det_obj_ids"):
        if not torch.equal(got[k].long(), want[k].long()):
            raise AssertionError(f"small {label}: {k} differs on the card")
    box_diff = (got["det_bboxes"] - want["det_bboxes"]).abs()
    box_err = float(box_diff.max())
    sseg = float((got["fcn_outputs"] == want["fcn_outputs"]).float().mean())
    pan = float((got["panoptic_outputs"] == want["panoptic_outputs"]).float().mean())
    ndet = int(want["det_valid"].sum())
    print(f"small: {label} card vs cpu: dets {ndet} equal, "
          f"box max err {box_err:.2e} (tol 2e-2), semantic agree {sseg:.5f}, "
          f"panoptic agree {pan:.5f} (tol 0.999)")
    if ndet == 0 or box_err > 2e-2 or sseg < 0.999 or pan < 0.999:
        worst = np.unravel_index(int(box_diff.argmax()), tuple(box_diff.shape))
        print(f"small: worst box {worst}: card {got['det_bboxes'][worst[:-1]]} "
              f"cpu {want['det_bboxes'][worst[:-1]]} probs card "
              f"{got['det_probs'][worst[:-1]]} cpu {want['det_probs'][worst[:-1]]}")
        raise AssertionError(f"small {label} disagrees between card and cpu")


def phase_small(device="cuda", dcn_window=None, kind="PanopticFuseTrack",
                refine_type="conv"):
    """Port on the card vs the port's plain CPU path, same weights, tiny
    exact-preset model (R-18, TinyFlow) of the detector ``kind`` on a
    3-frame 64x128 clip (with ``dcn_window``: the windowed kernel on the
    card, its plain version on the CPU; ``refine_type``: the fuse neck's)."""
    import torch
    from vps_torch.models.detectors import empty_track_state, predict_video

    cpu, gpu = _small_pair(device, kind, dcn_window, refine_type)
    rng = np.random.RandomState(SEED + 1)
    clip = torch.from_numpy(rng.randn(3, 1, 64, 128, 3).astype(np.float32))
    resets = [True, False, False]
    want, _ = predict_video(cpu, clip, resets, empty_track_state(64, device="cpu"),
                            clip[0])
    _reset_counts()
    got, _ = predict_video(gpu, clip.to(device), resets,
                           empty_track_state(64, device=device),
                           clip[0].to(device))
    if dcn_window and torch.device(device).type == "cuda" and \
            _counts()["dcw_fused"] != 12 * len(resets):
        raise AssertionError(f"small clip: {_counts()['dcw_fused']} "
                             f"windowed launches, want 12 a frame")
    _small_gates(f"{kind} exact dcn_window={dcn_window} refine_type="
                 f"{refine_type} 64x128 x3", got, want)


def phase_small_aug(device="cuda"):
    """predict_aug of the tiny exact FuseTrack on the card vs its plain CPU
    path: one 64x128 frame as 3 variants on one canvas (the frame, its flip,
    the frame at half scale in the top-left corner), under phase_small's
    gates."""
    import torch
    import torch.nn.functional as F
    from vps_torch.models.detectors import empty_track_state

    cpu, gpu = _small_pair(device)
    rng = np.random.RandomState(SEED + 7)
    img, ref = (torch.from_numpy(rng.randn(1, 64, 128, 3).astype(np.float32))
                for _ in range(2))

    def variants(x):
        half = F.interpolate(x.permute(0, 3, 1, 2), size=(32, 64),
                             mode="bilinear", align_corners=False)
        half = F.pad(half, (0, 64, 0, 32)).permute(0, 2, 3, 1)
        return torch.stack([x, x.flip(2), half])

    metas = (dict(flip=False, scale_ratio=1.0, img_shape=(64, 128)),
             dict(flip=True, scale_ratio=1.0, img_shape=(64, 128)),
             dict(flip=False, scale_ratio=0.5, img_shape=(32, 64)))
    want, _ = cpu.predict_aug(variants(img), variants(ref),
                              empty_track_state(64, device="cpu"), metas)
    got, _ = gpu.predict_aug(variants(img).to(device), variants(ref).to(device),
                             empty_track_state(64, device=device), metas)
    _small_gates("FuseTrack predict_aug x3 variants (identity, flip, scale "
                 "0.5) 64x128", got, want)


# ---------------------------------------------------------------------------
# The R-CNN zoo's inference at full width (mmdetection v1.0's public configs)
# ---------------------------------------------------------------------------

ZOO_HW = (800, 1333)  # mmdet v1's test scale (1333, 800)
ZOO_PAD = (800, 1344)  # padded by size divisor 32
ZOO_IMAGES = 5  # timed, after 1 warm-up
# the "zoo" phase's types, in order: Fast R-CNN takes the RPN's proposals
ZOO_OTHERS = ("rpn", "fast_rcnn", "faster_rcnn", "double_head", "ms_rcnn",
              "grid_rcnn")


def _mmdet_trunk(style="pytorch"):
    """The R-50-FPN trunk, RPN head and box RoI extractor of the mmdetection
    v1.0 configs (configs/*_r50_fpn_1x.py)."""
    backbone = dict(type="ResNet", depth=50, num_stages=4,
                    out_indices=(0, 1, 2, 3), frozen_stages=1, style=style)
    if style == "caffe":  # ms_rcnn/ms_rcnn_r50_caffe_fpn_1x.py
        backbone["norm_cfg"] = dict(type="BN", requires_grad=False)
    return dict(
        pretrained=("open-mmlab://resnet50_caffe" if style == "caffe"
                    else "torchvision://resnet50"),
        backbone=backbone,
        neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=256, num_outs=5),
        rpn_head=dict(
            type="RPNHead", in_channels=256, feat_channels=256,
            anchor_scales=[8], anchor_ratios=[0.5, 1.0, 2.0],
            anchor_strides=[4, 8, 16, 32, 64], target_means=[.0, .0, .0, .0],
            target_stds=[1.0, 1.0, 1.0, 1.0],
            loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True,
                          loss_weight=1.0),
            loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                           loss_weight=1.0)),
        bbox_roi_extractor=dict(
            type="SingleRoIExtractor",
            roi_layer=dict(type="RoIAlign", out_size=7, sample_num=2),
            out_channels=256, featmap_strides=[4, 8, 16, 32]))


def _mmdet_bbox_head(stds=(0.1, 0.1, 0.2, 0.2), agnostic=False, **over):
    return dict(dict(
        type="SharedFCBBoxHead", num_fcs=2, in_channels=256,
        fc_out_channels=1024, roi_feat_size=7, num_classes=81,
        target_means=[0., 0., 0., 0.], target_stds=list(stds),
        reg_class_agnostic=agnostic,
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False,
                      loss_weight=1.0),
        loss_bbox=dict(type="SmoothL1Loss", beta=1.0, loss_weight=1.0)),
        **over)


_MASK_ROI = dict(type="SingleRoIExtractor",
                 roi_layer=dict(type="RoIAlign", out_size=14, sample_num=2),
                 out_channels=256, featmap_strides=[4, 8, 16, 32])
_MASK_HEAD = dict(type="FCNMaskHead", num_convs=4, in_channels=256,
                  conv_out_channels=256, num_classes=81,
                  loss_mask=dict(type="CrossEntropyLoss", use_mask=True,
                                 loss_weight=1.0))
_RPN_TEST = dict(nms_across_levels=False, nms_pre=1000, nms_post=1000,
                 max_num=1000, nms_thr=0.7, min_bbox_size=0)
_CASCADE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
                 (0.033, 0.033, 0.067, 0.067))


def _zoo_train_rcnn(iou=0.5, **over):
    """An rcnn train_cfg of the mmdetection v1.0 configs: MaxIoU at ``iou``,
    512 RoIs sampled at 0.25 with the gt added, 28x28 mask targets."""
    return dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=iou,
                              neg_iou_thr=iou, min_pos_iou=iou,
                              ignore_iof_thr=-1),
                sampler=dict(type="RandomSampler", num=512, pos_fraction=0.25,
                             neg_pos_ub=-1, add_gt_as_proposals=True),
                mask_size=28, pos_weight=-1, debug=False, **over)


# the RPN's train_cfg and its train-time proposals, word for word
_RPN_TRAIN = dict(
    assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7, neg_iou_thr=0.3,
                  min_pos_iou=0.3, ignore_iof_thr=-1),
    sampler=dict(type="RandomSampler", num=256, pos_fraction=0.5,
                 neg_pos_ub=-1, add_gt_as_proposals=False),
    allowed_border=0, pos_weight=-1, debug=False)
_RPN_PROPOSAL = dict(nms_across_levels=False, nms_pre=2000, nms_post=2000,
                     max_num=2000, nms_thr=0.7, min_bbox_size=0)


def zoo_configs():
    """{name: (source config, model dict, train_cfg, test_cfg)}, written
    from the mmdetection v1.0 configs named."""
    rcnn = dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=100)
    train = dict(rpn=_RPN_TRAIN, rpn_proposal=_RPN_PROPOSAL,
                 rcnn=_zoo_train_rcnn())
    cascade_train = dict(train, rcnn=[_zoo_train_rcnn(t)
                                      for t in (0.5, 0.6, 0.7)],
                         stage_loss_weights=[1, 0.5, 0.25])
    masked = dict(rcnn, mask_thr_binary=0.5)
    cascade_heads = [_mmdet_bbox_head(s, agnostic=True) for s in _CASCADE_STDS]
    return {
        "mask_rcnn": ("configs/mask_rcnn_r50_fpn_1x.py", dict(
            type="MaskRCNN", **_mmdet_trunk(), bbox_head=_mmdet_bbox_head(),
            mask_roi_extractor=_MASK_ROI, mask_head=_MASK_HEAD), train,
            dict(rpn=_RPN_TEST, rcnn=masked)),
        "cascade_mask_rcnn": ("configs/cascade_mask_rcnn_r50_fpn_1x.py", dict(
            type="CascadeRCNN", num_stages=3, **_mmdet_trunk(),
            bbox_head=cascade_heads, mask_roi_extractor=_MASK_ROI,
            mask_head=_MASK_HEAD), cascade_train,
            dict(rpn=_RPN_TEST, rcnn=masked, keep_all_stages=False)),
        "htc": ("configs/htc/htc_r50_fpn_1x.py", dict(
            type="HybridTaskCascade", num_stages=3, interleaved=True,
            mask_info_flow=True, **_mmdet_trunk(), bbox_head=cascade_heads,
            mask_roi_extractor=_MASK_ROI,
            mask_head=dict(_MASK_HEAD, type="HTCMaskHead"),
            semantic_roi_extractor=dict(
                type="SingleRoIExtractor",
                roi_layer=dict(type="RoIAlign", out_size=14, sample_num=2),
                out_channels=256, featmap_strides=[8]),
            semantic_head=dict(
                type="FusedSemanticHead", num_ins=5, fusion_level=1,
                num_convs=4, in_channels=256, conv_out_channels=256,
                num_classes=183, ignore_label=255, loss_weight=0.2)),
            cascade_train, dict(rpn=_RPN_TEST, rcnn=dict(masked, score_thr=0.001),
                 keep_all_stages=False)),
        "rpn": ("configs/rpn_r50_fpn_1x.py", dict(
            type="RPN", **{k: v for k, v in _mmdet_trunk().items()
                           if k != "bbox_roi_extractor"}),
            dict(rpn=_RPN_TRAIN), dict(rpn=dict(_RPN_TEST, nms_pre=2000, nms_post=2000,
                          max_num=2000))),
        "faster_rcnn": ("configs/faster_rcnn_r50_fpn_1x.py", dict(
            type="FasterRCNN", **_mmdet_trunk(), bbox_head=_mmdet_bbox_head()),
            train, dict(rpn=_RPN_TEST, rcnn=rcnn)),
        "fast_rcnn": ("configs/fast_rcnn_r50_fpn_1x.py", dict(
            type="FastRCNN", **{k: v for k, v in _mmdet_trunk().items()
                                if k != "rpn_head"},
            bbox_head=_mmdet_bbox_head()),
            dict(rcnn=_zoo_train_rcnn()), dict(rcnn=rcnn)),
        "double_head": ("configs/double_heads/dh_faster_rcnn_r50_fpn_1x.py",
                        dict(type="DoubleHeadRCNN", reg_roi_scale_factor=1.3,
                             **_mmdet_trunk(), bbox_head=_mmdet_bbox_head(
                                 type="DoubleConvFCBBoxHead", num_convs=4,
                                 num_fcs=2, conv_out_channels=1024,
                                 loss_cls=dict(type="CrossEntropyLoss",
                                               use_sigmoid=False,
                                               loss_weight=2.0),
                                 loss_bbox=dict(type="SmoothL1Loss", beta=1.0,
                                                loss_weight=2.0))),
                        train, dict(rpn=_RPN_TEST, rcnn=rcnn)),
        "ms_rcnn": ("configs/ms_rcnn/ms_rcnn_r50_caffe_fpn_1x.py", dict(
            type="MaskScoringRCNN", **_mmdet_trunk("caffe"),
            bbox_head=_mmdet_bbox_head(), mask_roi_extractor=_MASK_ROI,
            mask_head=_MASK_HEAD,
            mask_iou_head=dict(type="MaskIoUHead", num_convs=4, num_fcs=2,
                               roi_feat_size=14, in_channels=256,
                               conv_out_channels=256, fc_out_channels=1024,
                               num_classes=81)),
            dict(train, rcnn=_zoo_train_rcnn(mask_thr_binary=0.5)),
            dict(rpn=_RPN_TEST, rcnn=masked)),
        "grid_rcnn": ("configs/grid_rcnn/grid_rcnn_gn_head_r50_fpn_2x.py", dict(
            type="GridRCNN", **_mmdet_trunk(),
            bbox_head=_mmdet_bbox_head(with_reg=False),
            grid_roi_extractor=_MASK_ROI,
            grid_head=dict(type="GridHead", grid_points=9, num_convs=8,
                           in_channels=256, point_feat_channels=64,
                           norm_cfg=dict(type="GN", num_groups=36),
                           loss_grid=dict(type="CrossEntropyLoss",
                                          use_sigmoid=True, loss_weight=15))),
            dict(train, rcnn=_zoo_train_rcnn(pos_radius=1, max_num_grid=192)),
            dict(rpn=_RPN_TEST, rcnn=dict(score_thr=0.03,
                                          nms=dict(type="nms", iou_thr=0.3),
                                          max_per_img=100))),
    }


# source keys the port (as vps_tpu) has no field for: what it does instead
_NO_COUNTERPART = {
    "norm_cfg": "dropped: FrozenBatchNorm, whose statistics never update, "
                "what norm_eval asks for; its affine weights train in the "
                "unfrozen stages, as vps_tpu's do, where mmdet's "
                "requires_grad=False would hold them",
    "with_reg": "dropped: vps_tpu's SharedFCBBoxHead always regresses and "
                "trains loss_bbox, and the grid votes refine the decoded "
                "boxes",
}
# the losses vps_tpu's loss computes, by head and config key: the port
# computes these whatever a config's loss_* asks
_VPS_TPU_LOSSES = {
    ("rpn_head", "loss_cls"): dict(type="CrossEntropyLoss", use_sigmoid=True,
                                   loss_weight=1.0),
    ("rpn_head", "loss_bbox"): dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                                    loss_weight=1.0),
    ("bbox_head", "loss_cls"): dict(type="CrossEntropyLoss",
                                    use_sigmoid=False, loss_weight=1.0),
    ("bbox_head", "loss_bbox"): dict(type="SmoothL1Loss", beta=1.0,
                                     loss_weight=1.0),
    ("mask_head", "loss_mask"): dict(type="CrossEntropyLoss", use_mask=True,
                                     loss_weight=1.0),
    ("grid_head", "loss_grid"): dict(type="CrossEntropyLoss",
                                     use_sigmoid=True, loss_weight=15),
}
# train_cfg keys the port (as vps_tpu) does not read, and why the result is
# what the config asks
_TRAIN_NOT_READ = {
    "ignore_iof_thr": lambda v: f"={v}: no ignore regions, none read",
    "neg_pos_ub": lambda v: f"={v}: no bound on negatives a positive, as "
                            f"read",
    "add_gt_as_proposals": lambda v: (
        "=True: the rcnn sampler always appends the gt" if v else
        "=False: the anchors only, as the RPN's targets take them"),
    "pos_weight": lambda v: f"={v}: positives weigh 1, as read",
    "debug": lambda v: f"={v}: not read",
    "nms_across_levels": lambda v: f"={v}: per-level NMS, as read",
    "nms_post": lambda v: f"={v}: not read (each level keeps <= nms_pre "
                          f"after its NMS)",
    "min_bbox_size": lambda v: f"={v}: not read (0 filters nothing)",
}


def _loss_note(where, key, spec):
    """What the port does with a config's loss dict: vps_tpu's fixed loss,
    and whether that is what the config asks."""
    fixed = _VPS_TPU_LOSSES[(where.split("[")[0], key)]
    asked = {k: v for k, v in spec.items() if k != "type"}
    differ = {k: (asked.get(k), fixed.get(k)) for k in set(asked) | set(fixed)
              if k != "type" and asked.get(k) != fixed.get(k)}
    if not differ and spec["type"] == fixed["type"]:
        return f"dropped: vps_tpu's loss is the one asked ({spec['type']})"
    return ("dropped: the port trains vps_tpu's loss, which has " + ", ".join(
        f"{k}={v[1]} where this config asks {v[0]}"
        for k, v in sorted(differ.items())))


def _zoo_train_notes(train_cfg):
    """The train_cfg keys no code reads, each with what the port does."""
    notes = []

    def walk(d, where):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{where}.{k}")
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                for i, x in enumerate(v):
                    walk(x, f"{where}.{k}[{i}]")
            elif k in _TRAIN_NOT_READ:
                notes.append(f"{where}.{k}{_TRAIN_NOT_READ[k](v)}")

    walk(train_cfg, "train_cfg")
    return notes


def _zoo_port_cfg(model):
    """The port's config of an mmdet model dict: the keys without a
    counterpart dropped (GridHead's GN norm_cfg read as norm_groups), each
    listed with what the port does instead."""
    notes = ["pretrained: not loaded, seeded random weights (random_init_)"]

    def clean(d, where):
        d = dict(d)
        for key in sorted(k for k, v in d.items()
                          if k.startswith("loss_") and isinstance(v, dict)):
            notes.append(f"{where}.{key}: {_loss_note(where, key, d.pop(key))}")
        for key in sorted(set(d) & set(_NO_COUNTERPART)):
            if key == "norm_cfg" and where == "grid_head":
                d["norm_groups"] = d.pop(key)["num_groups"]
                notes.append("grid_head.norm_cfg: its GN num_groups as "
                             "norm_groups")
            else:
                d.pop(key)
                notes.append(f"{where}.{key}: {_NO_COUNTERPART[key]}")
        return d

    out = {}
    for key, val in model.items():
        if isinstance(val, list):
            out[key] = [clean(v, f"{key}[{i}]") for i, v in enumerate(val)]
        elif isinstance(val, dict):
            out[key] = clean(val, key)
        else:
            out[key] = val
    return out, notes


def _zoo_test_notes(test_cfg):
    notes = []
    rpn = test_cfg.get("rpn", {})
    if "nms_post" in rpn:
        notes.append(f"rpn.nms_post={rpn['nms_post']}: not read (each level "
                     f"keeps <= nms_pre={rpn['nms_pre']} after its NMS)")
    if "min_bbox_size" in rpn:
        notes.append(f"rpn.min_bbox_size={rpn['min_bbox_size']}: not read "
                     f"(0 filters nothing)")
    if "nms_across_levels" in rpn:
        notes.append("rpn.nms_across_levels=False: per-level NMS, as read")
    if "keep_all_stages" in test_cfg:
        notes.append("keep_all_stages=False: the merged stages only, as read")
    if "mask_thr_binary" in test_cfg.get("rcnn", {}):
        notes.append("rcnn.mask_thr_binary: this script's paste reads it")
    return notes


def _zoo_image(device, hw=ZOO_HW, pad=ZOO_PAD):
    """The seeded image: ``hw`` (800x1333) of normalised values,
    zero-padded to ``pad`` (800x1344), (1, H, W, 3) on ``device``."""
    import torch

    rng = np.random.RandomState(SEED + 12)
    img = np.zeros((1,) + tuple(pad) + (3,), np.float32)
    img[0, :hw[0], :hw[1]] = rng.randn(*hw, 3)
    return torch.from_numpy(img).to(device)


def _zoo_profile(det, run, stages, label, unit="image"):
    """One more ``unit`` (an image, or a train step) under torch.profiler:
    per-range kernel and host ms, host syncs, the top kernels
    (vps_torch.profile's summary). Returns the host syncs of the unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vps_torch.profile import _device_kernels, _summary

    acts = [ProfilerActivity.CPU]
    if det.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(det.device)
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = _device_kernels(events, stages)
    syncs = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    print(f"{label}: one more {unit} under torch.profiler: wall {wall:.4f}s, "
          f"kernels {sum(kernels.values()) / 1e3:.1f} ms, device busy "
          f"{sum(kernels.values()) / (wall * 1e6):.3f}, host syncs {syncs}")
    _summary(events, kernels, stages, 1, unit, f"{label}: ", top=6)
    return syncs


def _zoo_check(name, out, det, h, w):
    """Finite outputs of the fixed capacities, boxes inside the image,
    labels in range, and at least one valid detection."""
    import torch

    if "proposals" in out:
        cap = det.test_cfg["rpn"]["max_num"]
        shapes = {"proposals": (cap, 4), "scores": (cap,),
                  "proposal_valid": (cap,)}
        valid = out["proposal_valid"]
        boxes = out["proposals"]
    else:
        cap = det.test_cfg["rcnn"]["max_per_img"]
        shapes = {"det_bboxes": (cap, 5), "det_labels": (cap,),
                  "det_valid": (cap,)}
        if "mask_logits" in out:
            shapes["mask_logits"] = (cap, 28, 28)
        if "mask_scores" in out:
            shapes["mask_scores"] = (cap,)
        valid = out["det_valid"]
        boxes = out["det_bboxes"][:, :4]
        labels = out["det_labels"][valid]
        if not bool(((labels >= 0) & (labels < 80)).all()):
            raise AssertionError(f"{name}: labels out of [0, 80)")
    for key, shape in shapes.items():
        t = out[key]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: {key} shape {tuple(t.shape)} != "
                                 f"{shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: {key} has non-finite values")
    nvalid = int(valid.sum())
    if nvalid == 0:
        raise AssertionError(f"{name}: no valid detection")
    b = boxes[valid]
    if not bool((b >= 0).all() & (b[:, 0::2] <= w - 1).all()
                & (b[:, 1::2] <= h - 1).all()):
        raise AssertionError(f"{name}: boxes outside the {h}x{w} image")
    return nvalid


def _zoo_run(name, smi, device, proposals=None, hw=ZOO_HW, pad=ZOO_PAD,
             images=ZOO_IMAGES):
    """Build ``name``'s detector at full width with seeded random weights,
    drive ``images`` images after 1 warm-up on the seeded image (``hw``
    padded to ``pad``), check the outputs, paste the masks at ``hw``,
    profile one more image. Returns (outputs, launch counts)."""
    import torch
    from vps_torch.models.detectors import build_detector, random_init_
    from vps_torch.ops.mask import paste_masks

    source, model, _, test_cfg = zoo_configs()[name]
    cfg, notes = _zoo_port_cfg(model)
    notes += _zoo_test_notes(test_cfg)
    t0 = time.perf_counter()
    det = random_init_(build_detector(cfg, test_cfg=test_cfg, device=device),
                       seed=SEED)
    _sync(device)
    init_s = time.perf_counter() - t0
    img = _zoo_image(device, hw, pad)
    args = () if proposals is None else proposals
    on_card = torch.device(device).type == "cuda"

    def run():
        return det.predict(img, *args)

    run()  # warm-up
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(images):
        out = run()
    _sync(device)
    ips = images / (time.perf_counter() - t0)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    nvalid = _zoo_check(name, out, det, *pad)
    stages = ("backbone_fpn", "rpn", "semantic_head", "bbox_dets", "mask",
              "grid")
    syncs = _zoo_profile(det, run, stages, name)
    extra = ""
    if "mask_logits" in out:
        thr = test_cfg["rcnn"]["mask_thr_binary"]
        valid = out["det_valid"]
        t0 = time.perf_counter()
        masks = paste_masks(torch.sigmoid(out["mask_logits"][valid]),
                            out["det_bboxes"][valid, :4], hw, binarize=thr)
        _sync(device)
        paste_s = time.perf_counter() - t0
        if tuple(masks.shape) != (nvalid,) + tuple(hw):
            raise AssertionError(f"{name}: pasted masks {tuple(masks.shape)}")
        area = masks.sum((1, 2))
        extra = (f", masks pasted at {hw[0]}x{hw[1]} and binarised at "
                 f"{thr}: {nvalid} in {paste_s * 1e3:.1f} ms, pixels a mask "
                 f"mean {float(area.mean()):.0f} (min {float(area.min()):.0f}, "
                 f"max {float(area.max()):.0f})")
        if "mask_scores" in out:
            ms = out["mask_scores"][valid]
            extra += (f", mask scores in [{float(ms.min()):.4f}, "
                      f"{float(ms.max()):.4f}]")
    what = "proposals" if "proposals" in out else "valid detections"
    print(f"{name}: {type(det).__name__} from mmdetection v1.0 {source}, R-50 "
          f"FPN, 81 classes, {hw[0]}x{hw[1]} padded to "
          f"{pad[0]}x{pad[1]}, init {init_s:.1f}s, "
          f"{ips:.3f} images/s over {images} images after 1 warm-up, peak "
          f"mem {peak / 2**30:.2f} GiB, {what} {nvalid}, host syncs an image "
          f"{syncs}, launches {launches}{extra}; TF32 off; card: {smi}")
    print(f"{name}: source keys without a counterpart: " + "; ".join(notes))
    if on_card and launches != _want():
        raise AssertionError(f"{name}: port kernel launches {launches}: the "
                             f"zoo's path runs none of them")
    return out, launches


def phase_zoo(smi, names, device="cuda", **kw):
    """Each named detector of zoo_configs at full width; Fast R-CNN takes
    the RPN's proposals (the rpn run must come first). ``kw``: _zoo_run's
    image size and count (a CPU rehearsal's). Returns the launch counts by
    path."""
    paths, props = {}, None
    for name in names:
        out, launches = _zoo_run(name, smi, device,
                                 props if name == "fast_rcnn" else None, **kw)
        if name == "rpn":
            props = (out["proposals"], out["proposal_valid"])
        paths[name] = launches
    return paths


# the tiny shapes of tests/test_two_stage.py (R-18, 32-wide FPN, 5 classes)
def _tiny_zoo_cfgs():
    trunk = dict(
        backbone=dict(type="ResNet", depth=18, frozen_stages=-1,
                      out_indices=(0, 1, 2, 3)),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=32, num_outs=5),
        rpn_head=dict(in_channels=32, feat_channels=32, anchor_scales=[8],
                      anchor_ratios=[0.5, 1.0, 2.0],
                      anchor_strides=[4, 8, 16, 32, 64]),
        bbox_roi_extractor=dict(roi_layer=dict(out_size=7, sample_num=2),
                                out_channels=32,
                                featmap_strides=[4, 8, 16, 32]))
    head = dict(num_classes=5, in_channels=32, fc_out_channels=32,
                roi_feat_size=7)
    mask = dict(mask_roi_extractor=dict(roi_layer=dict(out_size=14,
                                                       sample_num=2),
                                        featmap_strides=[4, 8, 16, 32]),
                mask_head=dict(num_convs=1, in_channels=32,
                               conv_out_channels=32, num_classes=5))
    stages = [dict(head, target_stds=s) for s in _CASCADE_STDS[:2]]
    htc = dict(trunk, num_stages=2, bbox_head=stages,
               mask_roi_extractor=mask["mask_roi_extractor"],
               mask_head=dict(mask["mask_head"], type="HTCMaskHead"),
               semantic_roi_extractor=dict(
                   roi_layer=dict(out_size=14, sample_num=2),
                   featmap_strides=[8]),
               semantic_head=dict(num_ins=5, fusion_level=1, num_convs=1,
                                  in_channels=32, conv_out_channels=32,
                                  num_classes=7))
    return {
        "FasterRCNN": dict(trunk, bbox_head=head),
        "MaskRCNN": dict(trunk, bbox_head=head, **mask),
        "FastRCNN": dict({k: v for k, v in trunk.items() if k != "rpn_head"},
                         bbox_head=head),
        "RPN": {k: trunk[k] for k in ("backbone", "neck", "rpn_head")},
        "DoubleHeadRCNN": dict(trunk, reg_roi_scale_factor=1.3, bbox_head=dict(
            type="DoubleConvFCBBoxHead", num_convs=1, num_fcs=1,
            in_channels=32, conv_out_channels=64, fc_out_channels=32,
            num_classes=5)),
        "MaskScoringRCNN": dict(
            trunk, bbox_head=head, **mask,
            mask_iou_head=dict(num_convs=2, num_fcs=1, roi_feat_size=14,
                               in_channels=32, conv_out_channels=32,
                               fc_out_channels=32, num_classes=5)),
        "GridRCNN": dict(
            trunk, bbox_head=head,
            grid_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                                    featmap_strides=[4, 8, 16, 32]),
            grid_head=dict(grid_points=4, num_convs=2, roi_feat_size=14,
                           in_channels=32, point_feat_channels=8,
                           norm_groups=4)),
        "CascadeRCNN": dict(trunk, num_stages=2, bbox_head=stages, **mask),
        "HybridTaskCascade": htc,
        "HTC": dict(htc, semantic_head=None, mask_info_flow=False),
    }


SMALL_ZOO_MASK_TOL = 2e-3


def phase_small_zoo(device="cuda"):
    """Each zoo type (and the HTC alias, without the semantic head or the
    flow) at tests/test_two_stage.py's tiny shapes on one seeded 64x64
    image: the card against the port's CPU path with the same weights,
    under phase_small's gates for detections (equal det_valid and
    det_labels, boxes and scores within 2e-2, at least one detection), mask
    logits and mask scores within SMALL_ZOO_MASK_TOL (the mask head's few
    convs in f32 on cuDNN against the CPU's: ~1e-5 of logits of magnitude
    ~1, so a tenth of a percent is a fault, not rounding)."""
    import torch
    from vps_torch.models.detectors import build_detector, random_init_

    test_cfg = dict(rpn=dict(nms_pre=16, nms_thr=0.7, max_num=8),
                    rcnn=dict(score_thr=0.05, nms=dict(type="nms",
                                                       iou_thr=0.5),
                              max_per_img=6))
    rng = np.random.RandomState(SEED + 13)
    img = torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32))
    props = torch.tensor([[2.0, 2.0, 30.0, 32.0], [28.0, 6.0, 62.0, 42.0],
                          [8.0, 30.0, 44.0, 62.0], [0.0, 0.0, 16.0, 16.0]] * 4)
    pvalid = torch.ones(16, dtype=torch.bool)
    for kind, cfg in _tiny_zoo_cfgs().items():
        cfg = dict(cfg, type=kind)
        cpu = random_init_(build_detector(cfg, test_cfg=test_cfg,
                                          device="cpu"), seed=SEED + 1)
        # a milder classifier, as _small_pair's: near-saturated
        # probabilities tie in f32 and reorder between the two devices
        with torch.no_grad():
            for n, m in cpu.named_modules():
                if n.endswith("fc_cls"):
                    m.weight.mul_(0.25)
                    m.bias.mul_(0.25)
        gpu = build_detector(cfg, test_cfg=test_cfg, device=device)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        extra = (props, pvalid) if kind == "FastRCNN" else ()
        want = cpu.predict(img, *extra)
        got = {k: v.cpu() for k, v in
               gpu.predict(img.to(device), *(a.to(device) for a in extra)).items()}
        if kind == "RPN":
            ok = torch.equal(got["proposal_valid"], want["proposal_valid"])
            err = float((got["proposals"] - want["proposals"]).abs().max())
            n = int(want["proposal_valid"].sum())
            print(f"small zoo: {kind} card vs cpu: proposals {n} "
                  f"{'equal' if ok else 'DIFFER'}, box max err {err:.2e} "
                  f"(tol 2e-2)")
            if not ok or n == 0 or err > 2e-2:
                raise AssertionError(f"small zoo {kind} disagrees")
            continue
        same = (torch.equal(got["det_valid"], want["det_valid"])
                and torch.equal(got["det_labels"], want["det_labels"]))
        err = float((got["det_bboxes"] - want["det_bboxes"]).abs().max())
        n = int(want["det_valid"].sum())
        merr = {k: float((got[k] - want[k]).abs().max())
                for k in ("mask_logits", "mask_scores") if k in want}
        print(f"small zoo: {kind} card vs cpu: dets {n} "
              f"{'equal' if same else 'DIFFER'}, box/score max err {err:.2e} "
              f"(tol 2e-2)" + "".join(
                  f", {k} max err {v:.2e} (tol {SMALL_ZOO_MASK_TOL:g})"
                  for k, v in merr.items()))
        if (not same or n == 0 or err > 2e-2
                or any(v > SMALL_ZOO_MASK_TOL for v in merr.values())):
            raise AssertionError(f"small zoo {kind} disagrees between card "
                                 f"and cpu")


# ---------------------------------------------------------------------------
# The R-CNN zoo's training at full width, the tiny zoo's training card vs
# CPU, and repeatable train steps under train_policy
# ---------------------------------------------------------------------------

ZOO_TRAIN_GT = 16  # gt capacity of a zoo train sample; 12 boxes valid
ZOO_TRAIN_THINGS = 12
ZOO_LR = 0.02 / 16  # mmdet v1's lr 0.02 for 16 images, for one image
# 1 warm-up + 3 timed steps for the first three, 1 + 2 for the rest; Fast
# R-CNN takes the RPN's proposals (the rpn run comes first)
ZOO_TRAIN_LONG = ("mask_rcnn", "cascade_mask_rcnn", "htc")
ZOO_TRAIN_OTHERS = ("rpn", "fast_rcnn", "faster_rcnn", "double_head",
                    "ms_rcnn", "grid_rcnn")
ZOO_TRAIN_STAGES = ("backbone_fpn", "rpn", "semantic_head", "proposal_targets",
                    "bbox_head", "mask_head", "grid")


def zoo_train_sample(rng, hw=ZOO_HW, pad=ZOO_PAD, things=ZOO_TRAIN_THINGS,
                     max_gt=ZOO_TRAIN_GT):
    """One seeded zoo training sample's gt on the padded canvas: ``things``
    ellipses in random boxes inside ``hw`` (labels 1..80; a later one
    occludes earlier ones, each mask keeping its visible pixels), padded to
    ``max_gt`` with gt_valid; and HTC's semantic labels at stride 8 (183
    classes in random blocks, 255 on the border and the padding)."""
    h, w = hw
    ys, xs = np.mgrid[0:pad[0], 0:pad[1]]
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    masks = np.zeros((max_gt,) + tuple(pad), np.uint8)
    for i in range(things):
        bw, bh = rng.randint(w // 20, w // 3), rng.randint(h // 20, h // 3)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        cx, cy = x1 + (bw - 1) / 2, y1 + (bh - 1) / 2
        inside = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1
        masks[:i][:, inside] = 0
        masks[i][inside] = 1
        labels[i] = rng.randint(1, 81)
        boxes[i] = (x1, y1, x1 + bw - 1, y1 + bh - 1)
    sh, sw = pad[0] // 8, pad[1] // 8
    blocks = rng.randint(0, 183, (sh // 10 + 1, sw // 12 + 1))
    seg = np.kron(blocks, np.ones((10, 12), np.int64))[:sh, :sw]
    seg[0], seg[:, 0] = 255, 255
    seg[h // 8:], seg[:, w // 8:] = 255, 255
    return dict(gt_bboxes=boxes, gt_labels=labels,
                gt_valid=np.arange(max_gt) < things, gt_masks=masks,
                gt_semantic_seg=seg[None].astype(np.int32))


def _zoo_train_det(name, device):
    """``name``'s detector of zoo_configs with its train_cfg, seeded random
    weights; returns it, the source config and the notes on keys without a
    counterpart."""
    from vps_torch.models.detectors import build_detector, random_init_

    source, model, train_cfg, test_cfg = zoo_configs()[name]
    cfg, notes = _zoo_port_cfg(model)
    det = random_init_(build_detector(cfg, train_cfg=train_cfg,
                                      test_cfg=test_cfg, device=device),
                       seed=SEED)
    return det, source, notes + _zoo_train_notes(train_cfg)


def _zoo_train_args(det, device, proposals=None, hw=ZOO_HW, pad=ZOO_PAD):
    """``det.loss``'s arguments on the seeded image and gt: the masks only
    with a mask head, the semantic labels only for HTC, the labels not for
    the RPN, ``proposals`` (boxes, valid) for a detector without an RPN."""
    import torch

    sample = zoo_train_sample(np.random.RandomState(SEED + 14), hw, pad)
    args = {k: torch.as_tensor(v, device=device) for k, v in sample.items()}
    args["img"] = _zoo_image(device, hw, pad)
    if getattr(det, "mask_head", None) is None:
        args.pop("gt_masks")
    if getattr(det, "semantic_head", None) is None:
        args.pop("gt_semantic_seg")
    if not hasattr(det, "bbox_head"):  # the RPN detector
        args.pop("gt_labels")
    elif det.rpn_head is None:
        args["proposals"], args["proposal_valid"] = proposals
    return args


def _zoo_optimizer(det):
    """The port's Optimizer as the mmdet v1 configs set SGD: momentum 0.9,
    weight decay 1e-4, clip 35, the lr of one image."""
    from vps_torch.train.optim import build_optimizer

    return build_optimizer(det, lambda step: np.float32(ZOO_LR), momentum=0.9,
                           weight_decay=1e-4, grad_clip=35.0)[0]


def _zoo_train_step(det, args, opt, gen):
    """One SGD step: ``loss``, the backward of the terms named loss, the
    update. Returns the loss dict."""
    losses = det.loss(**args, generator=gen)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    opt.step()
    return losses


def _zoo_train_run(name, smi, device, proposals=None, hw=ZOO_HW, pad=ZOO_PAD,
                   steps=None):
    """Train ``name`` at full width on the seeded image and gt under
    train_policy: 1 warm-up and ``steps`` - 1 timed steps (host clock,
    each ending in a synchronize), then one profiled step. Returns (launch
    counts of the steps, the detector)."""
    import torch
    from vps_torch.utils.numerics import train_policy

    steps = steps or (4 if name in ZOO_TRAIN_LONG else 3)
    t0 = time.perf_counter()
    det, source, notes = _zoo_train_det(name, device)
    args = _zoo_train_args(det, device, proposals, hw, pad)
    opt = _zoo_optimizer(det)
    before = {n: p.detach().clone() for n, p in det.named_parameters()}
    _sync(device)
    init_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    label = f"zoo train {name}"
    hist, times = [], []
    with train_policy():
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for _ in range(steps):
            t = time.perf_counter()
            losses = _zoo_train_step(det, args, opt, gen)
            _sync(device)
            times.append(time.perf_counter() - t)
            hist.append({k: float(v.detach()) for k, v in losses.items()})
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        syncs = _zoo_profile(det, lambda: _zoo_train_step(det, args, opt, gen),
                             ZOO_TRAIN_STAGES, label, unit="step")
    trainable = {n for n, p in det.named_parameters() if p.requires_grad}
    moved = {n for n, p in det.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    bad = sorted({k for r in hist for k, v in r.items() if not np.isfinite(v)})
    timed = times[1:]
    print(f"{label}: {type(det).__name__} from mmdetection v1.0 {source}, "
          f"R-50 FPN, 81 classes, {hw[0]}x{hw[1]} padded to {pad[0]}x{pad[1]}, "
          f"gt {ZOO_TRAIN_THINGS} of {ZOO_TRAIN_GT}, f32 TF32 off, "
          f"train_policy, lr {ZOO_LR:g}, init {init_s:.1f}s, first step "
          f"{times[0]:.3f}s, {statistics.mean(timed):.4f} s/step over "
          f"{len(timed)} steps (min {min(timed):.4f}, max {max(timed):.4f}), "
          f"peak mem {peak / 2**30:.2f} GiB, host syncs a step {syncs}, "
          f"nonfinite_skips {opt.total_notfinite}, launches {launches}, "
          f"trainable changed {len(moved & trainable)}/{len(trainable)}, "
          f"frozen changed {len(moved - trainable)}/"
          f"{len(before) - len(trainable)}; card: {smi}")
    print(f"{label}: step 1 {_losses_line(hist[0])}")
    print(f"{label}: step {len(hist)} {_losses_line(hist[-1])}")
    print(f"{label}: source keys without a counterpart: " + "; ".join(notes))
    if bad:
        raise AssertionError(f"{label}: non-finite {bad}")
    if opt.total_notfinite or opt.count != steps + 1:
        raise AssertionError(f"{label}: {opt.total_notfinite} steps skipped, "
                             f"{opt.count} applied")
    if moved - trainable or not moved & trainable:
        raise AssertionError(f"{label}: frozen changed "
                             f"{sorted(moved - trainable)[:5]}, trainable "
                             f"changed {len(moved & trainable)}")
    if on_card and launches != _want():
        raise AssertionError(f"{label}: port kernel launches {launches}: the "
                             f"zoo's training runs none of them")
    return launches, det


def phase_zoo_train(smi, names, device="cuda", **kw):
    """Each named detector of zoo_configs trained at full width
    (_zoo_train_run); Fast R-CNN on the proposals of the RPN detector just
    trained (predict on the same image). Returns the launch counts by
    path."""
    paths, props = {}, None
    for name in names:
        launches, det = _zoo_train_run(
            name, smi, device, props if name == "fast_rcnn" else None, **kw)
        if name == "rpn":
            hw, pad = kw.get("hw", ZOO_HW), kw.get("pad", ZOO_PAD)
            out = det.predict(_zoo_image(device, hw, pad))
            props = (out["proposals"], out["proposal_valid"])
        paths[f"zoo train {name}"] = launches
        del det
    return paths


# tests/test_two_stage.py's TRAIN_CFG and tests/test_cascade.py's two-stage
# train config, for the tiny zoo
_TINY_RPN_TRAIN = dict(
    assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7, neg_iou_thr=0.3,
                  min_pos_iou=0.3),
    sampler=dict(type="RandomSampler", num=32, pos_fraction=0.5),
    allowed_border=0)


def _tiny_rcnn_train(iou=0.5, **over):
    return dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=iou,
                              neg_iou_thr=iou, min_pos_iou=iou),
                sampler=dict(type="RandomSampler", num=16, pos_fraction=0.25,
                             add_gt_as_proposals=True),
                mask_size=28, pos_weight=-1, **over)


def _tiny_zoo_train_cfg(kind):
    if kind == "RPN":
        return dict(rpn=_TINY_RPN_TRAIN)
    base = dict(rpn=_TINY_RPN_TRAIN,
                rpn_proposal=dict(nms_pre=32, nms_thr=0.7, max_num=16))
    if kind in ("CascadeRCNN", "HybridTaskCascade", "HTC"):
        return dict(base, rcnn=[_tiny_rcnn_train(0.5), _tiny_rcnn_train(0.6)],
                    stage_loss_weights=[1.0, 0.5])
    return dict(base, rcnn=_tiny_rcnn_train(mask_thr_binary=0.5, pos_radius=1,
                                            max_num_grid=192))


# the card's gradients against the CPU's, each tensor within this share of
# its largest CPU gradient plus 1e-6 of the largest over all tensors: f32
# sums in other orders through the tiny nets (~1e-6 measured between JAX
# and the port on the CPU), so a tenth of a percent is a fault
SMALL_ZOO_GRAD_TOL = 1e-3


def phase_small_zoo_train(device="cuda"):
    """Each zoo type (and the HTC alias, without the semantic head or the
    flow, not interleaved) trained one step at tests/test_two_stage.py's
    tiny shapes on one seeded 64x64 image and gt: the card against the
    port's CPU path, the same weights and the same injected draws (each
    sampler call's (2, n) priorities and Grid's jitter from seeded numpy),
    both under train_policy. The sampled slots must be equal, every loss
    term within rel 1e-3, every parameter's gradient of the total within
    SMALL_ZOO_GRAD_TOL."""
    import torch
    import vps_torch.core.sampler as tsampler
    import vps_torch.core.targets as ttargets
    import vps_torch.models.detectors.two_stage as two_stage
    from vps_torch.models.detectors import build_detector, random_init_
    from vps_torch.utils.numerics import train_policy

    test_cfg = dict(rpn=dict(nms_pre=16, nms_thr=0.7, max_num=8),
                    rcnn=dict(score_thr=0.05, nms=dict(type="nms",
                                                       iou_thr=0.5),
                              max_per_img=6))
    rng = np.random.RandomState(SEED + 13)
    img = rng.randn(1, 64, 64, 3).astype(np.float32)
    boxes = np.asarray([[4, 4, 28, 30], [30, 8, 60, 40], [10, 34, 40, 60],
                        [0, 0, 0, 0]], np.float32)
    masks = np.zeros((4, 64, 64), np.float32)
    for i, b in enumerate(boxes.astype(int)):
        masks[i, b[1]:b[3], b[0]:b[2]] = 1
    sem = rng.randint(0, 7, (1, 8, 8)).astype(np.int32)
    sem[:, 0] = 255
    gt = dict(img=img, gt_bboxes=boxes,
              gt_labels=np.asarray([1, 2, 4, 0], np.int32),
              gt_valid=np.asarray([1, 1, 1, 0], bool), gt_masks=masks,
              gt_semantic_seg=sem,
              proposals=np.asarray([[2.0, 2.0, 30.0, 32.0],
                                    [28.0, 6.0, 62.0, 42.0],
                                    [8.0, 30.0, 44.0, 62.0],
                                    [0.0, 0.0, 16.0, 16.0]] * 4, np.float32),
              proposal_valid=np.arange(16) < 14)
    uniform, sample = tsampler.uniform, ttargets.random_sample
    jitter = two_stage.jitter_offsets
    for kind, cfg in _tiny_zoo_cfgs().items():
        cfg = dict(cfg, type=kind)
        if kind == "HTC":
            cfg["interleaved"] = False
        train_cfg = _tiny_zoo_train_cfg(kind)
        cpu = random_init_(build_detector(cfg, train_cfg=train_cfg,
                                          test_cfg=test_cfg, device="cpu"),
                           seed=SEED + 1)
        gpu = build_detector(cfg, train_cfg=train_cfg, test_cfg=test_cfg,
                             device=device)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        runs = {}
        for dev, det in (("cpu", cpu), ("card", gpu)):
            calls, sel = [0], []

            def feed(gen, shape, device):
                calls[0] += 1
                r = np.random.RandomState(100 + calls[0]).rand(*shape)
                return torch.from_numpy(r.astype(np.float32)).to(device)

            def recording(*a, **k):
                res = sample(*a, **k)
                sel.append((res.inds.cpu(), res.valid.cpu()))
                return res

            def jit(gen, shape, device, amp):
                r = np.random.RandomState(7).uniform(-amp, amp, shape)
                return torch.from_numpy(r.astype(np.float32)).to(device)

            args = {k: torch.from_numpy(v).to(det.device)
                    for k, v in gt.items()}
            if getattr(det, "mask_head", None) is None:
                args.pop("gt_masks")
            if getattr(det, "semantic_head", None) is None:
                args.pop("gt_semantic_seg")
            if kind == "RPN":
                args.pop("gt_labels")
            if kind != "FastRCNN":
                args.pop("proposals")
                args.pop("proposal_valid")
            tsampler.uniform, ttargets.random_sample = feed, recording
            two_stage.jitter_offsets = jit
            try:
                with train_policy():
                    losses = det.loss(**args)
                    sum(v for k, v in losses.items() if "loss" in k).backward()
            finally:
                tsampler.uniform, ttargets.random_sample = uniform, sample
                two_stage.jitter_offsets = jitter
            runs[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                         {n: p.grad.cpu() for n, p in det.named_parameters()
                          if p.grad is not None}, sel)
        (want, gw, ws), (got, gg, gs) = runs["cpu"], runs["card"]
        same_sel = len(ws) == len(gs) and all(
            torch.equal(a[1], b[1]) and torch.equal(a[0][a[1]], b[0][b[1]])
            for a, b in zip(ws, gs))
        rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items()
                  if k in got)
        gmax = max(float(g.abs().max()) for g in gw.values())
        gerr = max((float((gg[n] - g).abs().max())
                    / (float(g.abs().max()) + 1e-6 * gmax / SMALL_ZOO_GRAD_TOL))
                   for n, g in gw.items() if n in gg)
        print(f"small zoo train: {kind} card vs cpu: {len(want)} terms, "
              f"worst rel err {rel:.2e} (tol 1e-3), sampler calls {len(ws)} "
              f"{'equal' if same_sel else 'DIFFER'}, {len(gw)} gradients, "
              f"worst err {gerr:.2e} of the tensor's largest "
              f"(tol {SMALL_ZOO_GRAD_TOL:g})")
        if (set(got) != set(want) or not same_sel or rel > 1e-3
                or set(gg) != set(gw) or gerr > SMALL_ZOO_GRAD_TOL):
            raise AssertionError(f"small zoo train {kind} disagrees between "
                                 f"card and cpu")


def _repeat_steps(label, det, step, make_opt, seed=SEED):
    """Two train steps of ``det`` from the same weights, optimizer state
    (after one warm-up step: momentum set) and generator seed, under
    train_policy, compared bit for bit: every loss term and every
    parameter after the update. Where they part, the first module whose
    output differs in two forwards (every module hooked), else the first
    parameter whose gradient differs; then fails. ``step(opt, gen)`` runs
    one step and returns the loss dict. Returns the optimizer."""
    import copy

    import torch
    from vps_torch.utils.numerics import train_policy

    dev = det.device
    opt = make_opt()
    with train_policy():
        step(opt, torch.Generator(device=dev).manual_seed(seed))
    w0 = {k: v.clone() for k, v in det.state_dict().items()}
    o0 = copy.deepcopy(opt.state_dict())
    runs = []
    for _ in range(2):
        det.load_state_dict(w0)
        opt.load_state_dict(copy.deepcopy(o0))
        with train_policy():
            losses = step(opt, torch.Generator(device=dev).manual_seed(seed + 1))
        runs.append(({k: v.detach().clone() for k, v in losses.items()},
                     {n: p.detach().clone() for n, p in det.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    terms = [k for k in l0 if not torch.equal(l0[k], l1[k])]
    params = [n for n in p0 if not torch.equal(p0[n], p1[n])]
    print(f"train repeatable: {label}: two steps from the same weights, "
          f"optimizer state and generator seed under train_policy: loss terms "
          f"{len(l0) - len(terms)} of {len(l0)} bitwise equal, parameters "
          f"after the update {len(p0) - len(params)} of {len(p0)} bitwise "
          f"equal")
    if not terms and not params:
        return opt
    # where they part: every module's output in two forwards, then the
    # gradients
    modules = list(det.named_modules())[1:]
    seen = []
    for _ in range(2):
        det.load_state_dict(w0)
        opt.load_state_dict(copy.deepcopy(o0))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        with train_policy():
            pts, _ = _points(det, lambda record: step(opt, gen), modules)
        seen.append(pts)
    first = next((k for k in seen[0] if seen[1].get(k) != seen[0][k]), None)
    print(f"train repeatable: {label}: first point to differ in the forward: "
          f"{first}; loss terms that differ {terms[:5]}; parameters "
          f"{params[:5]}")
    raise AssertionError(f"train repeatable: {label} is not bitwise "
                         f"repeatable under train_policy")


def phase_train_repeatable(smi, device="cuda", h=TRAIN_H, w=TRAIN_W, depth=50,
                           zoo_hw=ZOO_HW, zoo_pad=ZOO_PAD, cost_steps=2):
    """The FuseTrack train step (the "train" path's model, sample and
    fusetrack_train_cfg) and Mask R-CNN's (the "zoo train" path's), each run
    twice from the same state under train_policy and compared bit for bit
    (_repeat_steps); then the policy's cost on the FuseTrack step: s/step
    in blocks of ``cost_steps`` steps without, with, with, without it (host
    clock, each step ending in a synchronize)."""
    import contextlib

    import torch
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_
    from vps_torch.train.step import make_loss_fn
    from vps_torch.utils.numerics import train_policy

    cfg = zoo.f32_compute_overrides(zoo.fusetrack_model_cfg(depth))
    cfg.pop("type")
    det = random_init_(PanopticFuseTrack(
        train_cfg=zoo.fusetrack_train_cfg(), test_cfg=zoo.fusetrack_test_cfg(),
        device=device, **cfg), seed=SEED)
    batch = SampleLoader(synth_sample(np.random.RandomState(SEED + 4), h, w,
                                      MAX_GT), device, 1).batch
    loss_fn = make_loss_fn(det)

    def fusetrack_step(opt, gen):
        total, log_vars = loss_fn(batch, gen)
        total.backward()
        opt.step()
        return log_vars

    def fusetrack_opt():
        from vps_torch.train.optim import build_optimizer

        return build_optimizer(det, lambda step: np.float32(0.005))[0]

    opt = _repeat_steps(f"PanopticFuseTrack R-{depth} f32 {h}x{w}", det,
                        fusetrack_step, fusetrack_opt)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def timed(n, policy):
        out = []
        for _ in range(n):
            with train_policy() if policy else contextlib.nullcontext():
                _sync(device)
                t = time.perf_counter()
                fusetrack_step(opt, gen)
                _sync(device)
            out.append(time.perf_counter() - t)
        return out

    timed(1, False)
    timed(1, True)
    off = timed(cost_steps, False)
    on = timed(cost_steps, True) + timed(cost_steps, True)
    off += timed(cost_steps, False)
    print(f"train repeatable: the policy's cost on the FuseTrack train step "
          f"(R-{depth} f32 {h}x{w}, steps in blocks without, with, with, "
          f"without): {statistics.mean(off):.4f} s/step without (min "
          f"{min(off):.4f}, max {max(off):.4f}), {statistics.mean(on):.4f} "
          f"s/step under train_policy (min {min(on):.4f}, max {max(on):.4f}), "
          f"{statistics.mean(on) / statistics.mean(off):.3f}x; card: {smi}")
    del det, opt, batch

    zdet, _, _ = _zoo_train_det("mask_rcnn", device)
    args = _zoo_train_args(zdet, device, hw=zoo_hw, pad=zoo_pad)
    _repeat_steps(f"mask_rcnn R-50 FPN {zoo_pad[0]}x{zoo_pad[1]}", zdet,
                  lambda o, g: _zoo_train_step(zdet, args, o, g),
                  lambda: _zoo_optimizer(zdet))


def main() -> int:
    import torch

    # fails outside a checkout of the repo
    from vps_torch.utils.numerics import (
        describe,
        deterministic_cublas,
        f32_policy,
    )

    numerics = f32_policy()
    deterministic_cublas()  # before CUDA: the train phases run train_policy
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(describe(numerics))
    t0 = time.perf_counter()
    smi = phase_build()
    kernels = phase_kernels_correlation() + [
        phase_kernels_correlation_backward(), phase_kernels_windowed()]
    paths = {"main": phase_main(smi),
             "window": phase_main(smi, dcn_window=WINDOW),
             "train": phase_train(smi),
             "fuse": phase_detector(smi, "PanopticFuse"),
             "track": phase_detector(smi, "PanopticTrack"),
             "aug": phase_aug(smi),
             "ohem train": phase_train(smi, steps=OHEM_STEPS, sampler=OHEM)}
    phase_small()
    phase_small(dcn_window=WINDOW)
    phase_small(kind="PanopticFuse")
    phase_small(kind="PanopticTrack")
    phase_small(refine_type="att")
    phase_small_aug()
    phase_small_train()
    phase_small_train(sampler=dict(OHEM, num=32))
    paths.update(phase_zoo(smi, ("mask_rcnn", "cascade_mask_rcnn", "htc")))
    paths.update({f"zoo {k}": v for k, v in phase_zoo(smi, ZOO_OTHERS).items()})
    phase_small_zoo()
    paths.update(phase_zoo_train(smi, ZOO_TRAIN_LONG + ZOO_TRAIN_OTHERS))
    phase_small_zoo_train()
    phase_train_repeatable(smi)
    paths.update(phase_dataset(smi, numerics))
    paths.update(phase_viper(smi))
    # launches: the run of the kernel's own path; by path: every path's run
    own = {"corr_bf16_tc": "main", "corr_f32": "train",
           "corr_backward": "train", "dcw_fused": "window"}
    for k in kernels:
        k["launches"] = paths[own[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
