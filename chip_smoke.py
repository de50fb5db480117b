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
                 and 3 timed SGD steps; prints s/step, peak memory, every
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
                 and 2 timed steps.
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
                 configs/cityscapes/fusetrack.py (R-50, f32, 2 steps),
                 tools.test_vpq at half-flow and tools.eval_vpq, in this
                 process; the train loader alone with 0 and 2 workers; fails
                 on a non-finite loss, a skipped step, a frame without an
                 artifact, VPQ outside [0, 100], the GT not scoring 100
                 against itself, or a kernel that did not launch; then
                 tools.test_vpq --aug (each frame and its flip) on the same
                 checkpoint, scored by tools.eval_vpq. On its fixture and
                 checkpoint, before they are removed:
     robustness -- tools.test_robustness at half-flow over the first val
                 video's first 2 frames, clean and under gaussian_noise,
                 motion_blur, fog and jpeg_compression at severities 1 and
                 5 (detections from score 0.001, the box-eval threshold of
                 mmdetection's HTC), then tools.robustness_eval; prints
                 frames/s, the corruption's host seconds a frame and
                 bbox_mAP per run, P, mPC, rPC; fails unless corr_bf16_tc
                 launched 2 a frame, the report has one entry a run and the
                 clean run's detections (at least one) equal predict's, bit
                 for bit, under inference_policy.
     detection eval -- the val fixture as an image-level CityscapesDataset
                 at Cityscapes' test scale (2048, 1024), the zoo's Mask
                 R-CNN and RetinaNet with 9 classes on seeded weights
                 (mmdetection's configs/cityscapes/
                 mask_rcnn_r50_fpn_1x_cityscapes.py); their detections
                 scored by tools.coco_eval and tools.voc_eval, then the GT
                 as its own detections, which must read AP 1.0000 at every
                 IoU threshold and mAP 1.0000, and tools.coco_error_analysis
                 --no-plots on it, whose C75 must read 1.0 for each class
                 with a gt; prints images/s and the evaluator's host
                 seconds; fails on a port kernel launched.
  6. viper    -- VIPER from files to VPQ: a synthetic fixture in VIPER's
                 format at 1080x1920 (tests/viper_fixture.py: 23 classes,
                 things 13..22; 1 train video of 2 frames, 2 val videos of
                 5), vps_torch.tools.train on the port's
                 configs/viper/fusetrack.py (R-50, f32, 2 steps),
                 tools.test_vpq at half-flow streamed (--chunk 4 --streams
                 2) and frame by frame (--chunk 1), VIPER's evaluator at
                 windows 1 and 5 (10 and 15 need longer videos; cut for
                 the script's time) and tools.eval_ipq, in this process;
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
                 2 steps for Mask R-CNN, Cascade Mask R-CNN and HTC, 1 + 1
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
  9. single stage -- RetinaNet, FCOS (caffe-style R-50), RepPoints
                 (moment) and SSD300 (VGG-16; the SingleStageDetector type)
                 at full width, written from the public mmdetection v1.0
                 configs (81 classes, test_cfg word for word, seeded
                 weights; ResNet's C3-C5 into an FPN whose P6 and P7 are
                 max pools, vps_tpu's nearest build of start_level=1 and
                 add_extra_convs; every key without a counterpart printed):
                 the zoo's seeded 800x1333 image padded to 800x1344 (SSD300
                 a seeded 300x300 one), 1 warm-up and 5 timed images each
                 ("single stage <name>"), the zoo's checks and one profiled
                 image (RepPoints' DCNs in the range reppoints_dcn); the
                 tiny configs of the CPU tests on the card against the CPU
                 ("small single stage"); the four trained at full width as
                 "zoo train" (1 warm-up + 1 step, 12 seeded gt of 16,
                 train_policy, "single stage train <name>"); and their tiny
                 loss one step on the card against the CPU ("small single
                 stage train": equal assignments, SSD's kept hard negatives
                 included, terms within rel 1e-3, gradients within
                 SMALL_ZOO_GRAD_TOL, SSD300's VGG convs in float64). No port
                 kernel runs on these paths: each fails on one launched.
 10. backbones -- six mmdetection v1.0 detectors on the remaining backbones
                 (DCN, modulated DCN with 4 groups, GCNet, the empirical
                 attention, ResNeXt-101, HRNetV2p-W32 with HRFPN) at full
                 width, their training ("backbones train ...") and the tiny
                 ones on the card against the CPU, as the zoo's phases.
 11. ga       -- GA-RetinaNet and GA-RPN (caffe R-50, 256-wide FPN, 81
                 classes, 4 deformable groups; written from mmdetection
                 v1.0's configs/guided_anchoring/, every key without a
                 counterpart printed) at full width on the zoo's seeded
                 image, under inference_policy: the masked forward and
                 ga_bboxes / ga_rpn_proposals, 1 warm-up and 2 timed images
                 ("ga <name>"), images/s, peak memory, host syncs, the share
                 of locations the loc filter keeps per level, one image
                 profiled by backbone_fpn, ga_head, feature_adaption,
                 ga_dets / ga_proposals; their training (ga_loss /
                 ga_rpn_loss, 1 warm-up + 1 step, train_policy, "ga train
                 <name>": fails on a non-finite term, a head parameter
                 without a gradient or a changed frozen one); the tiny heads
                 of the CPU tests on the card against the CPU ("small ga":
                 equal detections and proposals, boxes and scores within
                 1e-4; "small ga train": equal assignments and sampled
                 sets, terms within rel 1e-3, gradients within
                 SMALL_ZOO_GRAD_TOL; the MSE, balanced L1, bounded and
                 generalised IoU and GHM losses and masked_conv2d at
                 GA-RetinaNet's training sizes). No port
                 kernel runs on these paths: each fails on one launched.
 12. dist     -- data-parallel training across processes
                 (vps_torch.train.dist). "dist world 1", after the train
                 phase: its Runner for 2 steps without a process group and
                 at world size 1 over NCCL (init_dist, the broadcast, the
                 gradients' all-reduce, rank 0's checkpoint), from the same
                 weights, batches and generator: the parameters must be
                 bitwise equal. "dist step", after "ohem train": one step at
                 full width on a global batch of 2 in this process, then on
                 2 ranks (processes of their own, both on card 0, so over
                 gloo: NCCL refuses two ranks on one card), one sample
                 each: loss terms, all-reduced gradients and parameters
                 within DIST_TERM_TOL, DIST_GRAD_TOL, DIST_PARAM_TOL of the
                 one process's, the ranks bitwise equal; each rank's peak
                 memory, launches and the all-reduce's share of its step.
                 "dist train", in the dataset phase on its fixture:
                 vps_torch/tools/dist_train.sh NPROC=2 --dist-backend gloo
                 --device cuda:0, 2 epochs of 1 step, the eval hook each
                 epoch (each rank its val video, merged on rank 0): both
                 ranks exit 0, one checkpoint, hosts=2 in train.log, rank 1
                 logs nothing below ERROR, each epoch's merge holds every
                 val frame once; each rank's launches from the file it
                 writes.
 13. native   -- the native host library (vps_torch.native, g++) against
                 its numpy versions on seeded masks and boxes, with host ms
                 of each; the detection eval's IoU goes through it.
Each path is driven with every launch count set to 0 just before it and read
just after (a rank process counts its own; "dist step" and "dist train" sum
the ranks'). Then a `kernels` JSON line (corr_bf16_tc, corr_f32,
corr_backward, dcw_fused: each with the launches of its own path and
``launches_by_path``), the nvidia-smi line and, last, the result line
{"ok": true, "device": {...}}. Any failure raises: exit code != 0, no
result.
TF32 is off for matmuls and convolutions (vps_torch.utils.numerics.f32_policy,
printed first): float32 work runs in full float32, as the JAX reference
computes it.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import re
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
# max_gt, 1 warm-up + 3 timed steps; LiteFlowNetCorr's input at that crop
# (the 1/4 FPN level)
TRAIN_H, TRAIN_W, MAX_GT = 800, 1600, 100
TRAIN_STEPS = 4
# the "ohem train" path: the RCNN sampler OHEM, as mmdet's OHEM configs set
# it, 1 warm-up + 2 timed steps
OHEM = dict(type="OHEMSampler", num=512, pos_fraction=0.25)
OHEM_STEPS = 3
TRAIN_CORR = (1, TRAIN_H // 4, TRAIN_W // 4, 256)
# the "viper" phase: a synthetic fixture in VIPER's format at its frame size
# (1 train video of 2 frames, 2 val videos of 15: VIPER's largest VPQ
# window); the test scale (2048, 1024) takes the frame to 1820x1024, padded
# to 1824x1024; LiteFlowNetCorr's input is its 1/4 level
VIPER_H, VIPER_W = 1080, 1920
# 5 val frames a video, for the script's time: VIPER's windows 1 and 5 (10
# and 15 would need 10 and 15; the CPU tests run all four)
VIPER_TRAIN_FRAMES, VIPER_VAL_VIDEOS, VIPER_VAL_FRAMES = 2, 2, 5
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
    another order, to bf16, which can land one ulp apart. The plain version
    is timed at the named shapes, not the ragged ones."""
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
        plain = (float("nan") if name.startswith("ragged") else
                 cuda_ms(lambda: correlation_reference(f1, f2, md, s2), iters=20))
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
    JSON entry's times are the f32 training shape's (one launch a step);
    the plain version is timed at the named shapes, not the ragged ones."""
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
        plain = (float("nan") if name == "ragged" else cuda_ms(
            lambda: correlation_backward_reference(g, f1, f2, md, s2), iters=10))
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
    from vps_torch.ops import launch_counts

    return launch_counts()


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
                steps=TRAIN_STEPS, sampler=None, then=None):
    """FuseTrack training at full width (R-50, f32 compute as the trainer's
    default, fusetrack_train_cfg, batch 1) through the port's Runner over a
    synthetic sample: 1 warm-up step, then ``steps - 1`` timed ones (host
    clock around each step, ending in a synchronize). ``sampler``: the RCNN
    sampler's config in place of fusetrack_train_cfg's RandomSampler (the
    "ohem train" path); the determinism probe and the profiled step run only
    without it. ``then(det, loader)``: called last, with the trained
    detector and the loader ("dist world 1"). Returns the launch counts of
    the run."""
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
    if then is not None:
        then(det, loader)
    return launches


DATASET_CONFIG = """
_base_ = r"{base}"
data = dict(
    workers_per_gpu=0,
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
    """The config's train loader alone with 0 workers, the run's seed: host
    seconds until each batch of an epoch. (Its 2 workers took ~33 s more:
    their spawn and the first batch's 512 MB of masks; ROADMAP queue 2,
    "Card costs" item 1.)"""
    from vps_torch.config import Config
    from vps_torch.data import build_dataset, build_loader

    cfg = Config.fromfile(cfg_path)
    loader = build_loader(build_dataset(cfg.data["train"]), 1, seed=0,
                          num_workers=0)
    times = []
    try:
        t0 = time.perf_counter()
        for _ in loader.epoch(0):
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    finally:
        loader.close()
    return {0: times}


def phase_dataset(smi, numerics, device="cuda", h=H, w=W, tiny=False,
                  then=()):
    """The user's workflow from a dataset on disk, through the port's entry
    points in this process: the synthetic Cityscapes-VPS fixture
    (``vps_torch.data.synth``: 1 train video of 2 frames, 2 val videos of 4
    frames, h x w), the val GT through the repo's prepare_data scripts, then
    ``vps_torch.tools.train`` on the port's configs/cityscapes/fusetrack.py
    (R-50, f32, the config's own pipelines; data paths, 1 epoch of 2 steps
    and a log line a step overridden), ``vps_torch.tools.test_vpq`` on its
    checkpoint at ``half-flow`` and ``vps_torch.tools.eval_vpq``; and
    eval_vpq with the GT itself as the submission, which must read 100;
    then ``test_vpq --aug`` (each frame and its flip) on the same checkpoint,
    scored by eval_vpq. ``tiny``: the tiny model and pipelines at h x w, for
    a CPU rehearsal. ``then``: phases that run on the fixture and the
    checkpoint before they are removed, each called with a dict of their
    paths (``cfg``, ``ckpt``, ``val_ann``, ``val_img``, ``tmp``) and sizes
    (``val_frames``, ``val_videos``, ``tiny``, ``h``, ``w``) and
    returning its launch counts by path. Returns the launch counts of the
    train, test and aug runs (and of ``then``'s paths) by path."""
    import torch
    from vps_torch.data.synth import make_synth_vps
    from vps_torch.tools import eval_vpq, test_vpq, train
    from vps_torch.utils.checkpoint import latest_checkpoint
    from vps_torch.utils.numerics import describe

    on_card = torch.device(device).type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    # 4 frames a val video: VPQ's largest window, which 3 would leave empty
    train_frames, val_videos, val_frames = 2, 2, 4
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
        later = {}
        for phase in then:
            later.update(phase(dict(cfg=cfg_path, ckpt=ckpt, val_ann=val_ann,
                                    val_img=val_img, tmp=tmp,
                                    val_frames=val_frames,
                                    val_videos=val_videos, tiny=tiny, h=h,
                                    w=w)))

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
    return dict(got, **later)


ROBUST_FRAMES = 2  # the first two frames of the first val video
ROBUST_CORRUPTIONS = ("gaussian_noise", "motion_blur", "fog",
                      "jpeg_compression")
ROBUST_SEVERITIES = (5,)  # one severity, for the script's time (PERF.md §4)
# box mAP ranks the detections down to a low score: 0.001, the score_thr
# of mmdetection's HTC test_cfg (zoo_configs); the panoptic fusion's 0.6,
# and 0.05 too, kept none of a 4-step checkpoint's detections on clean frames
ROBUST_CONFIG = """
_base_ = r"{base}"
test_cfg = dict(panoptic=dict(score_thresh=0.001))
"""


def phase_robustness(smi, fx, device="cuda"):
    """The corruption benchmark on the dataset phase's fixture and
    checkpoint (R-50 FuseTrack at half-flow; ``fx``: phase_dataset's
    paths; ROBUST_CONFIG's detection threshold):
    ``vps_torch.tools.test_robustness`` in this process over the first val
    video's ROBUST_FRAMES frames, clean and under ROBUST_CORRUPTIONS x
    ROBUST_SEVERITIES, then ``tools.robustness_eval`` on its report. Fails
    unless the report has one entry a run, ``corr_bf16_tc`` launched 2 a
    frame and nothing else, and the clean run's detections (at least one)
    equal, bit for bit, ``predict``'s on the same frames under
    ``inference_policy`` (a detector of its own from the same checkpoint).
    Returns the launch counts by path."""
    import torch
    from vps_torch.config import Config
    from vps_torch.data import build_dataset
    from vps_torch.models.builder import build_detector
    from vps_torch.models.detectors import empty_track_state
    from vps_torch.tools import robustness_eval, test_robustness
    from vps_torch.utils.checkpoint import load_checkpoint
    from vps_torch.utils.numerics import inference_policy

    start = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    out_dir = os.path.join(fx["tmp"], "robustness")
    cfg_path = os.path.join(fx["tmp"], "robustness_cfg.py")
    with open(cfg_path, "w") as f:
        f.write(ROBUST_CONFIG.format(base=fx["cfg"]))
    runs = 1 + len(ROBUST_CORRUPTIONS) * len(ROBUST_SEVERITIES)
    _reset_counts()
    t0 = time.perf_counter()
    res = test_robustness.main(
        [cfg_path, "--checkpoint", fx["ckpt"], "--out", out_dir,
         "--max_frames", str(ROBUST_FRAMES), "--corruptions",
         *ROBUST_CORRUPTIONS, "--severities",
         *(str(v) for v in ROBUST_SEVERITIES), "--device", device])
    _sync(device)
    tool_s = time.perf_counter() - t0
    launches = _counts()
    report = res["report"]
    t0 = time.perf_counter()
    summary = robustness_eval.main([os.path.join(out_dir, "robustness.json")])
    summary_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = Config.fromfile(cfg_path)
    det = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg, device)
    det.load_state_dict(load_checkpoint(fx["ckpt"])["state_dict"])
    dataset = build_dataset(cfg.data["test"])
    num_fg = cfg.model["bbox_head"]["num_classes"] - 1
    want = []
    with inference_policy():
        state = empty_track_state(256, device=device)
        for idx in range(ROBUST_FRAMES):
            img, ref, meta = dataset.prepare_test(idx)
            if meta["is_first"]:
                state = empty_track_state(256, device=device)
            out, state = det.predict(
                torch.as_tensor(img, device=device)[None],
                torch.as_tensor(ref, device=device)[None], state,
                img_shape_withoutpad=tuple(meta["img_shape_withoutpad"]))
            want.append(test_robustness.det_lists(out, num_fg,
                                                  meta["scale_factor"]))
    _sync(device)
    replay_s = time.perf_counter() - t0
    got = res["det_results"]["clean"]
    same = sum(g.dtype == w.dtype and np.array_equal(g, w)
               for gi, wi in zip(got, want) for g, w in zip(gi, wi))
    ndet = sum(len(w) for wi in want for w in wi)

    print(f"robustness: test_robustness R-{cfg.model['backbone']['depth']} "
          f"FuseTrack half-flow, detections from score "
          f"{cfg.test_cfg['panoptic']['score_thresh']}, "
          f"{ROBUST_FRAMES} frames a run, {runs} runs (clean, "
          f"{' '.join(ROBUST_CORRUPTIONS)} at severities "
          f"{' '.join(map(str, ROBUST_SEVERITIES))}) in {tool_s:.1f}s, "
          f"launches {launches}; card: {smi}")
    for key, r in report.items():
        print(f"robustness: {key}: {r['fps']:.3f} frames/s (loading, "
              f"corruption, predict, detections to the host), corruption "
              f"{res['corrupt_s'][key]:.4f} s a frame on the host (image and "
              f"reference), {r['mean_detections']:.2f} detections a frame, "
              f"bbox_mAP {r['bbox_mAP']:.4f}")
    print(f"robustness: P {summary['P']:.4f}, mPC {summary['mPC']:.4f}, rPC "
          f"{summary['rPC']:.4f}; the clean run against predict under "
          f"inference_policy: {same} of {num_fg * ROBUST_FRAMES} class lists "
          f"bitwise equal ({ndet} detections); bbox_mAP from "
          f"{len(report)} runs of random weights trained a few steps is a "
          f"check of the chain, not a quality number")
    print(f"robustness: phase {time.perf_counter() - start:.1f}s wall: "
          f"test_robustness {tool_s:.1f}s, robustness_eval {summary_s:.3f}s, "
          f"the predict replay (detector build, checkpoint, "
          f"{ROBUST_FRAMES} frames) {replay_s:.1f}s")
    if sorted(report) != sorted(["clean"] + [
            f"{c}_s{v}" for c in ROBUST_CORRUPTIONS for v in ROBUST_SEVERITIES]):
        raise AssertionError(f"robustness: report runs {sorted(report)}")
    if any(r["frames"] != ROBUST_FRAMES for r in report.values()):
        raise AssertionError("robustness: a run with another frame count")
    if ndet == 0:
        raise AssertionError("robustness: no detection in the clean run")
    if same != num_fg * ROBUST_FRAMES:
        raise AssertionError(f"robustness: the clean run's detections differ "
                             f"from predict's in {num_fg * ROBUST_FRAMES - same}"
                             f" class lists")
    if on_card and launches != _want(corr_bf16_tc=2 * ROBUST_FRAMES * runs):
        raise AssertionError(f"robustness: launches {launches}, want 2 a "
                             f"frame over {ROBUST_FRAMES * runs} frames")
    return {"robustness": launches}


DETECTION_EVAL_CONFIG = """
data = dict(val=dict(type="CityscapesDataset", ann_file=r"{ann}",
                     img_prefix=r"{img}", test_mode=True,
                     pipeline=dict(img_scale={scale})))
"""
# mmdetection's configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py: the
# zoo's Mask R-CNN with 9 classes (8 things and the background), tested at
# Cityscapes' scale
CITYSCAPES_SCALE = (2048, 1024)


def phase_detection_eval(smi, fx, device="cuda", scale=CITYSCAPES_SCALE):
    """Box evaluation on the dataset phase's val fixture (``fx``) read as
    an image-level CityscapesDataset: the zoo's Mask R-CNN and RetinaNet,
    each with 9 classes (the fixture's 8 and the background), seeded
    weights, at ``scale``, over every val image; each one's per-class
    detections (at least one) to a pickle, scored by
    ``vps_torch.tools.coco_eval`` and ``voc_eval`` (numbers in [0, 1]; their
    values on seeded weights are not a gate); then the ground truth as its
    own detections (score 1),
    which must read AP 1.0000 at every IoU threshold and mAP 1.0000, and
    ``coco_error_analysis --no-plots`` on it as COCO results, whose C75
    must read 1.0 for each class with a gt. Fails on a port kernel
    launched. Returns the launch counts by path."""
    import torch
    from vps_torch.config import Config
    from vps_torch.data import build_dataset
    from vps_torch.models.builder import build_detector
    from vps_torch.models.detectors import random_init_
    from vps_torch.tools import (
        coco_error_analysis,
        coco_eval,
        test_robustness,
        voc_eval,
    )
    from vps_torch.utils.numerics import inference_policy

    start = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    tmp = os.path.join(fx["tmp"], "detection_eval")
    os.makedirs(tmp)
    cfg_path = os.path.join(tmp, "cfg.py")
    with open(cfg_path, "w") as f:
        f.write(DETECTION_EVAL_CONFIG.format(ann=fx["val_ann"],
                                             img=fx["val_img"],
                                             scale=tuple(scale)))
    dataset = build_dataset(Config.fromfile(cfg_path).data["val"])
    source, model, _, test_cfg = zoo_configs()["mask_rcnn"]
    model = dict(model, bbox_head=dict(model["bbox_head"], num_classes=9),
                 mask_head=dict(model["mask_head"], num_classes=9))
    r_source, r_model, _, r_test, _ = single_stage_configs()["retinanet"]
    r_model = dict(r_model, bbox_head=dict(r_model["bbox_head"],
                                           num_classes=9))
    models = {"Mask R-CNN": (source, _zoo_port_cfg(model)[0], test_cfg),
              "RetinaNet": (r_source, _single_port_cfg(r_model)[0], r_test)}
    runs, n = {}, len(dataset)
    for key, (src, cfg, tcfg) in models.items():
        t0 = time.perf_counter()
        det = random_init_(build_detector(cfg, test_cfg=tcfg, device=device),
                           seed=SEED)
        _sync(device)
        build_s = time.perf_counter() - t0
        dets, load_s, pred_s = [], [], []
        with inference_policy():
            _reset_counts()
            t0 = time.perf_counter()
            for idx in range(n):
                t1 = time.perf_counter()
                img, _, meta = dataset.prepare_test(idx)
                t2 = time.perf_counter()
                out = det.predict(torch.as_tensor(img, device=device)[None])
                dets.append(test_robustness.det_lists(out, 8,
                                                      meta["scale_factor"]))
                load_s.append(t2 - t1)
                pred_s.append(time.perf_counter() - t2)
            _sync(device)
            loop_s = time.perf_counter() - t0
            launches = _counts()
        runs[key] = dict(source=src, kind=type(det).__name__, dets=dets,
                         build_s=build_s, loop_s=loop_s, load_s=load_s,
                         pred_s=pred_s, launches=launches,
                         ndet=sum(len(c) for d in dets for c in d))
        del det
    gt_dets = []
    for idx in range(n):
        ann = dataset.get_ann_info(idx)
        gt_dets.append([np.concatenate(
            [ann["bboxes"][ann["labels"] == c + 1],
             np.ones(((ann["labels"] == c + 1).sum(), 1), np.float32)], 1)
            for c in range(8)])
    scores, eval_s = {}, {}
    for key, results in [(k, r["dets"]) for k, r in runs.items()] + [
            ("the GT", gt_dets)]:
        pkl = os.path.join(tmp, f"{key}.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(results, f)
        t0 = time.perf_counter()
        coco = coco_eval.main([pkl, cfg_path])
        voc = voc_eval.main([pkl, cfg_path])[0]
        eval_s[key] = time.perf_counter() - t0
        scores[key] = (coco, voc)
    with open(fx["val_ann"]) as f:
        gt_json = json.load(f)
    res_json = os.path.join(tmp, "gt_results.json")
    with open(res_json, "w") as f:
        json.dump([dict(image_id=a["image_id"], category_id=a["category_id"],
                        bbox=a["bbox"], score=1.0)
                   for a in gt_json["annotations"]], f)
    t0 = time.perf_counter()
    analysis = coco_error_analysis.main(
        [res_json, os.path.join(tmp, "analysis"), "--ann", fx["val_ann"],
         "--no-plots"])["bbox"]
    analysis_s = time.perf_counter() - t0
    with_gt = sorted({c["name"] for c in gt_json["categories"]
                      for a in gt_json["annotations"]
                      if a["category_id"] == c["id"]})
    c75 = {name: analysis[name]["C75"]["allarea"] for name in with_gt}

    for r in runs.values():
        print(f"detection eval: {r['kind']} from mmdetection v1.0 "
              f"{r['source']} with 9 classes (as configs/cityscapes/"
              f"mask_rcnn_r50_fpn_1x_cityscapes.py), seeded weights, "
              f"CityscapesDataset over the val fixture ({n} images at "
              f"img_scale {tuple(scale)}), {n / r['loop_s']:.3f} images/s "
              f"(loading, predict, detections to the host; the first image "
              f"{r['pred_s'][0]:.3f} s of predict, the others' median "
              f"{statistics.median(r['pred_s'][1:]):.4f} s, loading a median "
              f"{statistics.median(r['load_s']):.4f} s), {r['ndet']} "
              f"detections, launches {r['launches']}; card: {smi}")
    for key, (coco, voc) in scores.items():
        print(f"detection eval: {key} as detections: coco_eval "
              + " ".join(f"{k} {v:.4f}" for k, v in coco.items())
              + f"; voc_eval mAP {voc:.4f}; evaluator {eval_s[key]:.3f} s "
              f"on the host")
    print(f"detection eval: coco_error_analysis --no-plots on the GT as its "
          f"results in {analysis_s:.3f} s: C75 (allarea) "
          + ", ".join(f"{k} {v:.4f}" for k, v in c75.items())
          + f"; allclass over all 8 classes "
          + " ".join(f"{t} {analysis['allclass'][t]['allarea']:.4f}"
                     for t in ("C75", "C50", "Loc", "BG", "FN")))
    print(f"detection eval: phase {time.perf_counter() - start:.1f}s wall: "
          + ", ".join(f"{k} build and seeded init {r['build_s']:.1f}s, {n} "
                      f"images (loading, predict) {r['loop_s']:.1f}s"
                      for k, r in runs.items())
          + f", coco_eval and voc_eval {len(scores)} times "
          f"{sum(eval_s.values()):.3f}s, coco_error_analysis "
          f"{analysis_s:.3f}s")
    coco_gt, voc_gt = scores["the GT"]
    if not all(v == 1.0 for v in coco_gt.values()) or voc_gt != 1.0:
        raise AssertionError(f"detection eval: the GT as detections reads "
                             f"{coco_gt}, voc mAP {voc_gt}, not 1.0")
    if not with_gt or any(v != 1.0 for v in c75.values()):
        raise AssertionError(f"detection eval: the GT's C75 {c75}, not 1.0")
    for key, r in runs.items():
        coco, voc = scores[key]
        ok = (r["ndet"] > 0 and 0.0 <= voc <= 1.0
              and all(0.0 <= v <= 1.0 for v in coco.values()))
        if not ok:
            raise AssertionError(f"detection eval: {key}: {r['ndet']} "
                                 f"detections, coco_eval {coco}, voc {voc}")
        if on_card and r["launches"] != _want():
            raise AssertionError(f"detection eval: {key}: port kernel "
                                 f"launches {r['launches']}: its path runs "
                                 f"none")
    return {"detection eval": runs["Mask R-CNN"]["launches"],
            "detection eval retinanet": runs["RetinaNet"]["launches"]}


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
    1 train video of 2 frames, 2 val videos of ``val_frames``) at h x w;
    ``vps_torch.tools.train`` on the port's configs/viper/fusetrack.py
    (R-50, f32, the loader in this process, 1 epoch of 2 steps);
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
                                      viper_vpq_windows)
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
        gt_pq = {nf: r["All"]["pq"] for nf, r in
                 viper_vpq_windows(videos, cats, windows).items()}
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
ZOO_OTHERS_IMAGES = 2  # the "zoo others" phase's, for the script's time
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
    (vps_torch.profile's summary), the time the profile took to read.
    Returns the host syncs of the unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vps_torch.profile import _summary, read_profile

    acts = [ProfilerActivity.CPU]
    if det.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(det.device)
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = read_profile(prof, stages)
    read_s = time.perf_counter() - t0
    total = sum(p.kernels.values())
    print(f"{label}: one more {unit} under torch.profiler: wall {wall:.4f}s, "
          f"kernels {total / 1e3:.1f} ms, device busy "
          f"{total / (wall * 1e6):.3f}, host syncs {p.syncs}")
    _summary(p, stages, 1, unit, f"{label}: ", top=6)
    print(f"{label}: the profile read in {read_s:.1f}s")
    return p.syncs


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
        cap = det.test_cfg.get("rcnn", det.test_cfg)["max_per_img"]
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


ZOO_STAGES = ("backbone_fpn", "rpn", "semantic_head", "bbox_dets", "mask",
              "grid")


def _zoo_config(name):
    """(source, model, train_cfg, test_cfg) of ``name`` in zoo_configs or
    backbone_configs."""
    return {**zoo_configs(), **backbone_configs()}[name]


def _zoo_run(name, smi, device, proposals=None, hw=ZOO_HW, pad=ZOO_PAD,
             images=ZOO_IMAGES, stages=ZOO_STAGES, probe=None, label=None):
    """Build ``name``'s detector at full width with seeded random weights,
    drive ``images`` images after 1 warm-up on the seeded image (``hw``
    padded to ``pad``), check the outputs, paste the masks at ``hw``,
    profile one more image by the named ranges ``stages``, then call
    ``probe(det, run)`` if given. Returns (outputs, launch counts)."""
    import torch
    from vps_torch.models.detectors import build_detector, random_init_
    from vps_torch.ops.mask import paste_masks

    label = label or name
    source, model, _, test_cfg = _zoo_config(name)
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
    syncs = _zoo_profile(det, run, stages, label)
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
    print(f"{label}: {type(det).__name__} from mmdetection v1.0 {source}, "
          f"{_trunk(det)}, 81 classes, {hw[0]}x{hw[1]} padded to "
          f"{pad[0]}x{pad[1]}, init {init_s:.1f}s, "
          f"{ips:.3f} images/s over {images} images after 1 warm-up, peak "
          f"mem {peak / 2**30:.2f} GiB, {what} {nvalid}, host syncs an image "
          f"{syncs}, launches {launches}{extra}; TF32 off; card: {smi}")
    print(f"{label}: source keys without a counterpart: " + "; ".join(notes))
    if on_card and launches != _want():
        raise AssertionError(f"{label}: port kernel launches {launches}: the "
                             f"zoo's path runs none of them")
    if probe is not None:
        probe(det, run)
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


def phase_small_zoo(device="cuda", cfgs=None, label="small zoo"):
    """Each zoo type (and the HTC alias, without the semantic head or the
    flow) at tests/test_two_stage.py's tiny shapes on one seeded 64x64
    image: the card against the port's CPU path with the same weights,
    under phase_small's gates for detections (equal det_valid and
    det_labels, boxes and scores within 2e-2, at least one detection), mask
    logits and mask scores within SMALL_ZOO_MASK_TOL (the mask head's few
    convs in f32 on cuDNN against the CPU's: ~1e-5 of logits of magnitude
    ~1, so a tenth of a percent is a fault, not rounding). ``cfgs``: {key:
    config} (the type is the config's ``type``, else the key), by default
    _tiny_zoo_cfgs()."""
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
    for key, cfg in (cfgs or _tiny_zoo_cfgs()).items():
        kind = cfg.get("type", key)
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
            print(f"{label}: {key} card vs cpu: proposals {n} "
                  f"{'equal' if ok else 'DIFFER'}, box max err {err:.2e} "
                  f"(tol 2e-2)")
            if not ok or n == 0 or err > 2e-2:
                raise AssertionError(f"{label} {key} disagrees")
            continue
        same = (torch.equal(got["det_valid"], want["det_valid"])
                and torch.equal(got["det_labels"], want["det_labels"]))
        err = float((got["det_bboxes"] - want["det_bboxes"]).abs().max())
        n = int(want["det_valid"].sum())
        merr = {k: float((got[k] - want[k]).abs().max())
                for k in ("mask_logits", "mask_scores") if k in want}
        print(f"{label}: {key} card vs cpu: dets {n} "
              f"{'equal' if same else 'DIFFER'}, box/score max err {err:.2e} "
              f"(tol 2e-2)" + "".join(
                  f", {k} max err {v:.2e} (tol {SMALL_ZOO_MASK_TOL:g})"
                  for k, v in merr.items()))
        if (not same or n == 0 or err > 2e-2
                or any(v > SMALL_ZOO_MASK_TOL for v in merr.values())):
            raise AssertionError(f"{label} {key} disagrees between card "
                                 f"and cpu")


# ---------------------------------------------------------------------------
# The R-CNN zoo's training at full width, the tiny zoo's training card vs
# CPU, and repeatable train steps under train_policy
# ---------------------------------------------------------------------------

ZOO_TRAIN_GT = 16  # gt capacity of a zoo train sample; 12 boxes valid
ZOO_TRAIN_THINGS = 12
ZOO_LR = 0.02 / 16  # mmdet v1's lr 0.02 for 16 images, for one image
# 1 warm-up + 2 timed steps for the first three, 1 + 1 for the rest; Fast
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

    source, model, train_cfg, test_cfg = _zoo_config(name)
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
    elif getattr(det, "rpn_head", False) is None:  # FastRCNN
        args["proposals"], args["proposal_valid"] = proposals
    return args


def _trunk(det):
    """The trunk's name: VGG-16, HRNetV2p-W<w> HRFPN, or R-<depth> /
    X-<depth>-<groups>x<width>d FPN with its plugins."""
    from vps_torch.models.resnet import BasicBlock, Bottleneck

    b = det.backbone
    kind = type(b).__name__
    if kind == "SSDVGG":
        return "VGG-16"
    if kind == "HRNet":
        return f"HRNetV2p-W{b.stage2[0].branches[0][0].conv1.out_channels} HRFPN"
    blocks = [m for m in b.modules() if isinstance(m, (Bottleneck,
                                                       BasicBlock))]
    if not isinstance(blocks[0], Bottleneck):
        return f"R-{2 * len(blocks) + 2} FPN"
    depth = 3 * len(blocks) + 2
    c2 = b.layer1[0].conv2
    name = (f"R-{depth}" if getattr(c2, "groups", 1) == 1 else
            f"X-{depth}-{c2.groups}x{c2.weight.shape[0] // c2.groups}d")
    plugins = []
    dcn = [m.conv2 for m in blocks if m.conv2_offset is not None]
    if dcn:
        plugins.append(f"{'modulated ' if dcn[0].modulated else ''}DCN "
                       f"(deformable groups {dcn[0].groups}) x{len(dcn)}")
    gcb = sum(m.context_block is not None for m in blocks)
    if gcb:
        plugins.append(f"ContextBlock x{gcb}")
    att = sum(m.gen_attention_block is not None for m in blocks)
    if att:
        plugins.append(f"GeneralizedAttention x{att}")
    return " ".join([name] + plugins + ["FPN"])


def _zoo_optimizer(det):
    """The port's Optimizer as the mmdet v1 configs set SGD: momentum 0.9,
    weight decay 1e-4, clip 35, the lr of one image."""
    from vps_torch.train.optim import build_optimizer

    return build_optimizer(det, lambda step: np.float32(ZOO_LR), momentum=0.9,
                           weight_decay=1e-4, grad_clip=35.0)[0]


def _zoo_train_step(det, args, opt, gen, on_grads=None):
    """One SGD step: ``loss``, the backward of the terms named loss,
    ``on_grads(det)`` if given, the update. Returns the loss dict."""
    losses = det.loss(**args, generator=gen)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    if on_grads is not None:
        on_grads(det)
    opt.step()
    return losses


def _zoo_train_run(name, smi, device, proposals=None, hw=ZOO_HW, pad=ZOO_PAD,
                   steps=None, make=None, stages=ZOO_TRAIN_STAGES,
                   label=None, on_grads=None):
    """Train ``name`` at full width on the seeded image and gt under
    train_policy: 1 warm-up and ``steps`` - 1 timed steps (host clock,
    each ending in a synchronize), then one profiled step by the named
    ranges ``stages`` (none when ``stages`` is None). ``make(name,
    device)`` builds the detector (_zoo_train_det: the R-CNN zoo's);
    ``on_grads(det)`` reads the first step's gradients before its update.
    Returns (launch counts of the steps, the detector)."""
    import torch
    from vps_torch.utils.numerics import train_policy

    steps = steps or (3 if name in ZOO_TRAIN_LONG else 2)
    t0 = time.perf_counter()
    det, source, notes = (make or _zoo_train_det)(name, device)
    args = _zoo_train_args(det, device, proposals, hw, pad)
    opt = _zoo_optimizer(det)
    before = {n: p.detach().clone() for n, p in det.named_parameters()}
    _sync(device)
    init_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    label = label or f"zoo train {name}"
    hist, times = [], []
    with train_policy():
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for i in range(steps):
            t = time.perf_counter()
            losses = _zoo_train_step(det, args, opt, gen,
                                     on_grads if i == 0 else None)
            _sync(device)
            times.append(time.perf_counter() - t)
            hist.append({k: float(v.detach()) for k, v in losses.items()})
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        syncs = ("not profiled" if stages is None else _zoo_profile(
            det, lambda: _zoo_train_step(det, args, opt, gen), stages, label,
            unit="step"))
    trainable = {n for n, p in det.named_parameters() if p.requires_grad}
    moved = {n for n, p in det.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    bad = sorted({k for r in hist for k, v in r.items() if not np.isfinite(v)})
    timed = times[1:]
    print(f"{label}: {type(det).__name__} from mmdetection v1.0 {source}, "
          f"{_trunk(det)}, 81 classes, {hw[0]}x{hw[1]} padded to "
          f"{pad[0]}x{pad[1]}, "
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
    # the profiled step applies an update too
    if opt.total_notfinite or opt.count != steps + (stages is not None):
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


def phase_small_zoo_train(device="cuda", cfgs=None, label="small zoo train"):
    """Each zoo type (and the HTC alias, without the semantic head or the
    flow, not interleaved) trained one step at tests/test_two_stage.py's
    tiny shapes on one seeded 64x64 image and gt: the card against the
    port's CPU path, the same weights and the same injected draws (each
    sampler call's (2, n) priorities and Grid's jitter from seeded numpy),
    both under train_policy. The sampled slots must be equal, every loss
    term within rel 1e-3, every parameter's gradient of the total within
    SMALL_ZOO_GRAD_TOL. ``cfgs`` as phase_small_zoo's."""
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
    for key, cfg in (cfgs or _tiny_zoo_cfgs()).items():
        kind = cfg.get("type", key)
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
        print(f"{label}: {key} card vs cpu: {len(want)} terms, "
              f"worst rel err {rel:.2e} (tol 1e-3), sampler calls {len(ws)} "
              f"{'equal' if same_sel else 'DIFFER'}, {len(gw)} gradients, "
              f"worst err {gerr:.2e} of the tensor's largest "
              f"(tol {SMALL_ZOO_GRAD_TOL:g})")
        if (set(got) != set(want) or not same_sel or rel > 1e-3
                or set(gg) != set(gw) or gerr > SMALL_ZOO_GRAD_TOL):
            raise AssertionError(f"{label} {key} disagrees between "
                                 f"card and cpu")


# ---------------------------------------------------------------------------
# The zoo's remaining backbones (DCN, GCNet, the empirical attention,
# ResNeXt, HRNetV2p with HRFPN) at full width, their training, and the tiny
# ones on the card against the CPU
# ---------------------------------------------------------------------------

BACKBONE_NAMES = ("dcn_mask_rcnn", "mdconv_g4_faster_rcnn", "gcb_mask_rcnn",
                  "attention_faster_rcnn", "x101_mask_rcnn",
                  "hrnet_faster_rcnn")
BACKBONE_IMAGES = 3  # timed, after 1 warm-up
BACKBONE_TRAIN_STEPS = 2  # 1 warm-up + 1 timed
_BACKBONE_RANGES = ("backbone", "backbone_dcn", "backbone_attention",
                  "backbone_gcb", "neck")
BACKBONE_STAGES = ("backbone_fpn",) + _BACKBONE_RANGES + ("rpn", "bbox_dets",
                                                        "mask")
# the extra dict of configs/hrnet/faster_rcnn_hrnetv2p_w32_1x.py
_HRNET_W32 = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)))


def _r50(**plugins):
    """The backbone of the mmdetection v1.0 R-50 configs, with ``plugins``."""
    return dict(type="ResNet", depth=50, num_stages=4,
                out_indices=(0, 1, 2, 3), frozen_stages=1, style="pytorch",
                **plugins)


def backbone_configs():
    """{name: (source config, model dict, train_cfg, test_cfg)} of the
    detectors on the remaining backbones, written from the mmdetection
    v1.0 configs named (their trunk, heads, train_cfg and test_cfg are
    mask_rcnn_r50_fpn_1x's or faster_rcnn_r50_fpn_1x's)."""
    rcnn = dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=100)
    train = dict(rpn=_RPN_TRAIN, rpn_proposal=_RPN_PROPOSAL,
                 rcnn=_zoo_train_rcnn())
    faster_test = dict(rpn=_RPN_TEST, rcnn=rcnn)
    mask_test = dict(rpn=_RPN_TEST, rcnn=dict(rcnn, mask_thr_binary=0.5))
    c3_c5 = (False, True, True, True)

    def faster(backbone, **trunk):
        return dict(type="FasterRCNN", **dict(_mmdet_trunk(), backbone=backbone,
                                              **trunk),
                    bbox_head=_mmdet_bbox_head())

    def mask(backbone, **trunk):
        return dict(faster(backbone, **trunk), type="MaskRCNN",
                    mask_roi_extractor=_MASK_ROI, mask_head=_MASK_HEAD)

    return {
        "dcn_mask_rcnn": ("configs/dcn/mask_rcnn_dconv_c3-c5_r50_fpn_1x.py",
                          mask(_r50(dcn=dict(modulated=False,
                                             deformable_groups=1,
                                             fallback_on_stride=False),
                                    stage_with_dcn=c3_c5)),
                          train, mask_test),
        "mdconv_g4_faster_rcnn": (
            "configs/dcn/faster_rcnn_mdconv_c3-c5_group4_r50_fpn_1x.py",
            faster(_r50(dcn=dict(modulated=True, deformable_groups=4,
                                 fallback_on_stride=False),
                        stage_with_dcn=c3_c5)), train, faster_test),
        "gcb_mask_rcnn": ("configs/gcnet/mask_rcnn_r16_gcb_c3-c5_r50_fpn_1x.py",
                          mask(_r50(gcb=dict(ratio=1. / 16.),
                                    stage_with_gcb=c3_c5)),
                          train, mask_test),
        "attention_faster_rcnn": (
            "configs/empirical_attention/"
            "faster_rcnn_r50_fpn_attention_1111_1x.py",
            faster(_r50(gen_attention=dict(spatial_range=-1, num_heads=8,
                                           attention_type="1111",
                                           kv_stride=2),
                        stage_with_gen_attention=[[], [], [0, 1, 2, 3, 4, 5],
                                                  [0, 1, 2]])),
            train, faster_test),
        "x101_mask_rcnn": ("configs/mask_rcnn_x101_32x4d_fpn_1x.py",
                           mask(dict(type="ResNeXt", depth=101, groups=32,
                                     base_width=4, num_stages=4,
                                     out_indices=(0, 1, 2, 3), frozen_stages=1,
                                     style="pytorch"),
                                pretrained="open-mmlab://resnext101_32x4d"),
                           train, mask_test),
        "hrnet_faster_rcnn": ("configs/hrnet/faster_rcnn_hrnetv2p_w32_1x.py",
                              faster(dict(type="HRNet", extra=_HRNET_W32),
                                     neck=dict(type="HRFPN",
                                               in_channels=[32, 64, 128, 256],
                                               out_channels=256),
                                     pretrained="open-mmlab://msra/"
                                                "hrnetv2_w32"),
                              train, faster_test),
    }


def _plugin_probe(label):
    """``_zoo_run``'s probe: one more image with hooks on the backbone's
    DCNs and ContextBlocks; prints the offsets' mean |value| in pixels and
    the share of the DCNs' samples outside their map (beside the share at
    zero offsets: the padding's taps), each ContextBlock's mean |change|
    against its input's mean |value|, and every attention block's gamma."""
    def probe(det, run):
        import torch
        from vps_torch.models.plugins import ContextBlock, GeneralizedAttention
        from vps_torch.models.resnet import DeformConv2

        dcn, gcb = [], []

        def on_dcn(m, inputs, out):
            x, off = inputs
            h, w = x.shape[-2:]
            o = off[:, :m.groups * 18].float()
            b, _, ho, wo = o.shape
            o = o.reshape(b, m.groups, 9, 2, ho, wo)
            k = torch.arange(9, device=o.device)
            ky = ((k // 3) * m.dilation).float()[:, None, None]
            kx = ((k % 3) * m.dilation).float()[:, None, None]
            gy = (torch.arange(ho, device=o.device) * m.stride
                  - m.dilation).float()[:, None]
            gx = (torch.arange(wo, device=o.device) * m.stride
                  - m.dilation).float()[None, :]
            y0, x0 = gy + ky, gx + kx  # (9, Ho, Wo) at zero offsets
            ys, xs = y0 + o[:, :, :, 0], x0 + o[:, :, :, 1]

            def outside(yy, xx):
                return ((yy < 0) | (yy > h - 1) | (xx < 0) | (xx > w - 1)
                        ).float().mean()

            dcn.append(torch.stack([o.abs().mean(), o.abs().max(),
                                    outside(ys, xs), outside(y0, x0)]))

        def on_gcb(m, inputs, out):
            (x,) = inputs
            gcb.append(torch.stack([(out - x).abs().mean(), x.abs().mean()]))

        hooks = [m.register_forward_hook(on_dcn if isinstance(m, DeformConv2)
                                         else on_gcb)
                 for m in det.backbone.modules()
                 if isinstance(m, (DeformConv2, ContextBlock))]
        try:
            run()
        finally:
            for hk in hooks:
                hk.remove()
        if dcn:
            d = torch.stack(dcn).cpu().numpy()
            print(f"{label}: {len(d)} DCNs: mean |offset| "
                  f"{d[:, 0].mean():.4f} px (per DCN {d[:, 0].min():.4f}-"
                  f"{d[:, 0].max():.4f}, largest {d[:, 1].max():.4f}), "
                  f"samples outside the map {d[:, 2].mean():.4f} (at zero "
                  f"offsets {d[:, 3].mean():.4f})")
        if gcb:
            g = torch.stack(gcb).cpu().numpy()
            print(f"{label}: {len(g)} ContextBlocks: mean |change| "
                  f"{g[:, 0].mean():.4f} against mean |input| "
                  f"{g[:, 1].mean():.4f} (per block {g[:, 0].min():.4f}-"
                  f"{g[:, 0].max():.4f})")
        gammas = [float(m.gamma.detach()) for m in det.backbone.modules()
                  if isinstance(m, GeneralizedAttention)]
        if gammas:
            print(f"{label}: {len(gammas)} attention blocks, gamma "
                  + ", ".join(f"{v:.4f}" for v in gammas))
    return probe


def phase_backbones(smi, names=BACKBONE_NAMES, device="cuda", **kw):
    """Each named detector of backbone_configs at full width (_zoo_run,
    BACKBONE_IMAGES timed images), the backbone_fpn range split into the
    backbone, its plugins and the neck, and the plugins' probe. Returns the
    launch counts by path."""
    kw.setdefault("images", BACKBONE_IMAGES)
    paths = {}
    for name in names:
        label = f"backbones {name}"
        _, paths[label] = _zoo_run(name, smi, device, stages=BACKBONE_STAGES,
                                   probe=_plugin_probe(label), label=label,
                                   **kw)
    return paths


def _plugin_grads(label):
    """``_zoo_train_run``'s check of step 1's gradients: every trainable
    DCN offset conv weight, attention gamma and ContextBlock weight has a
    finite gradient that is not zero."""
    def check(det):
        import torch

        names, bad = [], []
        for n, p in det.named_parameters():
            plugin = (".conv2_offset.weight" in n or n.endswith(".gamma")
                      or (".context_block." in n and n.endswith(".weight")))
            if not plugin or not p.requires_grad:
                continue
            names.append(n)
            g = p.grad
            if (g is None or not bool(torch.isfinite(g).all())
                    or float(g.abs().max()) == 0.0):
                bad.append(n)
        print(f"{label}: step 1 gradients of {len(names)} plugin parameters "
              f"(DCN offset convs, attention gammas, ContextBlock weights): "
              f"{len(names) - len(bad)} finite and non-zero")
        if bad:
            raise AssertionError(f"{label}: no gradient for {bad[:5]}")
    return check


def phase_backbones_train(smi, names=BACKBONE_NAMES, device="cuda", **kw):
    """Each named detector of backbone_configs trained at full width
    (_zoo_train_run: BACKBONE_TRAIN_STEPS steps under train_policy, the
    plugins' gradients checked on step 1, no profiled step: the DCN
    configs' took 12 s). Returns the launch counts by path."""
    paths = {}
    for name in names:
        label = f"backbones train {name}"
        paths[label], det = _zoo_train_run(
            name, smi, device, steps=BACKBONE_TRAIN_STEPS, stages=None,
            label=label, on_grads=_plugin_grads(label), **kw)
        del det
    return paths


def _tiny_backbone_cfgs():
    """The tiny detectors of tests/test_torch_port_backbone_zoo*.py (HRNet
    + HRFPN Faster R-CNN; Mask R-CNN on an R-50 with DCN, ContextBlocks
    and the attention), and a Faster R-CNN on a ResNeXt-50 32x4d with
    modulated DCN in 4 groups, each with tests/test_two_stage.py's
    32-wide heads."""
    tiny = _tiny_zoo_cfgs()
    hr = dict(
        stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                    num_blocks=(1,), num_channels=(16,)),
        stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                    num_blocks=(1, 1), num_channels=(8, 16)),
        stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                    num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
        stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                    num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)))
    fpn = dict(type="FPN", in_channels=(256, 512, 1024, 2048),
               out_channels=32, num_outs=5)
    c3_c5 = (False, True, True, True)
    return {
        "hrnet FasterRCNN": dict(
            tiny["FasterRCNN"], type="FasterRCNN",
            backbone=dict(type="HRNet", extra=hr),
            neck=dict(type="HRFPN", in_channels=(8, 16, 32, 64),
                      out_channels=32, num_outs=5)),
        "plugins MaskRCNN": dict(
            tiny["MaskRCNN"], type="MaskRCNN", neck=fpn,
            backbone=_r50(dcn=dict(modulated=False, deformable_groups=1,
                                   fallback_on_stride=False),
                          stage_with_dcn=c3_c5, gcb=dict(ratio=1. / 16.),
                          stage_with_gcb=c3_c5,
                          gen_attention=dict(spatial_range=-1, num_heads=8,
                                             attention_type="1111",
                                             kv_stride=2),
                          stage_with_gen_attention=((), (), (0, 1, 2, 3, 4, 5),
                                                    (0, 1, 2)))),
        "x50 mdconv FasterRCNN": dict(
            tiny["FasterRCNN"], type="FasterRCNN", neck=fpn,
            backbone=dict(type="ResNeXt", depth=50, groups=32, base_width=4,
                          frozen_stages=1,
                          dcn=dict(modulated=True, deformable_groups=4),
                          stage_with_dcn=c3_c5)),
    }


def phase_small_backbone_ops(device="cuda"):
    """roi_pool, deform_roi_pool and ConvWS (no detector of the port calls
    them) on the card against the CPU at a stride-16 level of the zoo's
    image (50x84, 256 channels) with 512 seeded RoIs: roi_pool's maxima
    equal, deform_roi_pool's means within 1e-5 and ConvWS (256 -> 256,
    3x3) within 1e-4 of the largest value (f32, TF32 off)."""
    import torch
    from vps_torch.models.layers import ConvWS
    from vps_torch.ops.roi_pool import deform_roi_pool, roi_pool

    rng = np.random.RandomState(SEED + 15)
    feat = torch.from_numpy(rng.randn(50, 84, 256).astype(np.float32))
    xy = rng.rand(512, 2) * np.asarray([1200.0, 700.0])
    wh = 16.0 + rng.rand(512, 2) * 300.0
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    off = torch.from_numpy((0.1 * rng.randn(512, 7, 7, 2)).astype(np.float32))
    conv = ConvWS(256, 256, 3, 1, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            (rng.randn(256, 256, 3, 3) / 48.0 + 0.01).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(0.02 * rng.randn(256).astype(
            np.float32)))
    card = ConvWS(256, 256, 3, 1, 1, device=device)
    card.load_state_dict(conv.state_dict())
    x = feat.permute(2, 0, 1)[None]
    d = torch.device(device)
    cases = (
        ("roi_pool 7x7", lambda t: roi_pool(t(feat), t(rois), 1 / 16, 7), 0.0),
        ("deform_roi_pool 7x7", lambda t: deform_roi_pool(
            t(feat), t(rois), t(off), 1 / 16, 7), 1e-5),
        ("ConvWS 256->256 3x3", lambda t: (card if t(x).is_cuda else conv)(
            t(x)), 1e-4))
    with torch.no_grad():
        for name, fn, tol in cases:
            want = fn(lambda a: a)
            got = fn(lambda a: a.to(d)).cpu()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"small backbone ops: {name} card vs cpu: max err "
                  f"{err:.3e} of largest {scale:.3e} (tol {tol:g} of it)")
            if tuple(got.shape) != tuple(want.shape) or err > tol * scale:
                raise AssertionError(f"small backbone ops: {name} disagrees "
                                     f"between card and cpu")


# ---------------------------------------------------------------------------
# The single-stage detectors (RetinaNet, FCOS, RepPoints, SSD300) at full
# width, their training, and the tiny ones on the card against the CPU
# ---------------------------------------------------------------------------

SSD_HW = (300, 300)  # ssd300_coco's input: no padding
SINGLE_NAMES = ("retinanet", "fcos", "reppoints", "ssd300")
SINGLE_STAGES = ("backbone_fpn", "bbox_head", "reppoints_dcn", "bbox_dets")
SINGLE_TRAIN_STAGES = ("backbone_fpn", "bbox_head", "reppoints_dcn",
                       "bbox_loss")
SINGLE_TRAIN_STEPS = 2  # 1 warm-up + 1 timed
_FOCAL = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
              loss_weight=1.0)
_DENSE_TEST = dict(nms_pre=1000, min_bbox_size=0, score_thr=0.05,
                   nms=dict(type="nms", iou_thr=0.5), max_per_img=100)
_DENSE_ASSIGNER = dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                       neg_iou_thr=0.4, min_pos_iou=0, ignore_iof_thr=-1)
_DENSE_TRAIN = dict(assigner=_DENSE_ASSIGNER, allowed_border=-1,
                    pos_weight=-1, debug=False)


def single_stage_configs():
    """{name: (source config, model dict, train_cfg, test_cfg, (hw, pad))},
    written from the mmdetection v1.0 configs named, as zoo_configs."""
    def resnet(style="pytorch"):
        b = dict(type="ResNet", depth=50, num_stages=4,
                 out_indices=(0, 1, 2, 3), frozen_stages=1, style=style)
        if style == "caffe":
            b["norm_cfg"] = dict(type="BN", requires_grad=False)
        return b

    fpn = dict(type="FPN", in_channels=[256, 512, 1024, 2048],
               out_channels=256, start_level=1, add_extra_convs=True,
               num_outs=5)
    gn = dict(type="GN", num_groups=32, requires_grad=True)
    smooth = dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)
    big = (ZOO_HW, ZOO_PAD)
    return {
        "retinanet": ("configs/retinanet_r50_fpn_1x.py", dict(
            type="RetinaNet", pretrained="torchvision://resnet50",
            backbone=resnet(), neck=fpn, bbox_head=dict(
                type="RetinaHead", num_classes=81, in_channels=256,
                stacked_convs=4, feat_channels=256, octave_base_scale=4,
                scales_per_octave=3, anchor_ratios=[0.5, 1.0, 2.0],
                anchor_strides=[8, 16, 32, 64, 128],
                target_means=[.0, .0, .0, .0],
                target_stds=[1.0, 1.0, 1.0, 1.0], loss_cls=_FOCAL,
                loss_bbox=smooth)), _DENSE_TRAIN, _DENSE_TEST, big),
        "fcos": ("configs/fcos/fcos_r50_caffe_fpn_gn_1x_4gpu.py", dict(
            type="FCOS", pretrained="open-mmlab://resnet50_caffe",
            backbone=resnet("caffe"),
            neck=dict(fpn, extra_convs_on_inputs=False,
                      relu_before_extra_convs=True),
            bbox_head=dict(
                type="FCOSHead", num_classes=81, in_channels=256,
                stacked_convs=4, feat_channels=256,
                strides=[8, 16, 32, 64, 128], loss_cls=_FOCAL,
                loss_bbox=dict(type="IoULoss", loss_weight=1.0),
                loss_centerness=dict(type="CrossEntropyLoss",
                                     use_sigmoid=True, loss_weight=1.0))),
            _DENSE_TRAIN, _DENSE_TEST, big),
        "reppoints": ("configs/reppoints/reppoints_moment_r50_fpn_1x.py", dict(
            type="RepPointsDetector", pretrained="torchvision://resnet50",
            backbone=resnet(), neck=dict(fpn, norm_cfg=gn), bbox_head=dict(
                type="RepPointsHead", num_classes=81, in_channels=256,
                feat_channels=256, point_feat_channels=256, stacked_convs=3,
                num_points=9, gradient_mul=0.1,
                point_strides=[8, 16, 32, 64, 128], point_base_scale=4,
                norm_cfg=gn, loss_cls=_FOCAL,
                loss_bbox_init=dict(smooth, loss_weight=0.5),
                loss_bbox_refine=smooth, transform_method="moment")),
            dict(init=dict(assigner=dict(type="PointAssigner", scale=4,
                                         pos_num=1),
                           allowed_border=-1, pos_weight=-1, debug=False),
                 refine=dict(assigner=_DENSE_ASSIGNER, allowed_border=-1,
                             pos_weight=-1, debug=False)),
            _DENSE_TEST, big),
        "ssd300": ("configs/ssd300_coco.py", dict(
            type="SingleStageDetector", pretrained="open-mmlab://vgg16_caffe",
            backbone=dict(type="SSDVGG", input_size=300, depth=16,
                          with_last_pool=False, ceil_mode=True,
                          out_indices=(3, 4), out_feature_indices=(22, 34),
                          l2_norm_scale=20),
            neck=None, bbox_head=dict(
                type="SSDHead", input_size=300,
                in_channels=(512, 1024, 512, 256, 256, 256), num_classes=81,
                anchor_strides=(8, 16, 32, 64, 100, 300),
                basesize_ratio_range=(0.15, 0.9),
                anchor_ratios=([2], [2, 3], [2, 3], [2, 3], [2], [2]),
                target_means=(.0, .0, .0, .0),
                target_stds=(0.1, 0.1, 0.2, 0.2))),
            dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                               neg_iou_thr=0.5, min_pos_iou=0.,
                               ignore_iof_thr=-1, gt_max_assign_all=False),
                 smoothl1_beta=1., allowed_border=-1, pos_weight=-1,
                 neg_pos_ratio=3, debug=False),
            dict(nms=dict(type="nms", iou_thr=0.45), min_bbox_size=0,
                 score_thr=0.02, max_per_img=200), (SSD_HW, SSD_HW)),
    }


# source keys the single-stage detectors (as vps_tpu's) have no field for,
# by detector type and (where, key): what the port does instead
_NECK_DROPPED = {
    ("backbone", "norm_cfg"): _NO_COUNTERPART["norm_cfg"],
    ("neck", "start_level"): "vps_tpu's FPN has none: it takes C3-C5 "
                             "(ResNet out_indices=(1, 2, 3), in_channels "
                             "512, 1024, 2048), the levels start_level=1 "
                             "asks for",
    ("neck", "add_extra_convs"): "vps_tpu's FPN has no extra convs: P6 and "
                                 "P7 are stride-2 max pools (kernel 1) of "
                                 "P5 and P6, at the strides 64 and 128 "
                                 "asked",
    ("neck", "extra_convs_on_inputs"): "no extra convs (add_extra_convs)",
    ("neck", "relu_before_extra_convs"): "no extra convs (add_extra_convs)",
    ("neck", "norm_cfg"): "vps_tpu's FPN has no GN: plain convs",
}
_SINGLE_DROPPED = {
    "RetinaNet": {
        ("bbox_head", "octave_base_scale"): "RetinaNet's anchors are fixed "
                                            "in vps_tpu: octave base 4, as "
                                            "asked",
        ("bbox_head", "scales_per_octave"): "fixed: 3 scales an octave, as "
                                            "asked",
        ("bbox_head", "anchor_ratios"): "fixed: 0.5, 1, 2, as asked",
        ("bbox_head", "anchor_strides"): "fixed: 8-128, as asked",
        ("bbox_head", "target_means"): "not read: RetinaNet decodes with "
                                       "means 0 and stds 1 (vps_tpu), the "
                                       "values asked",
        ("bbox_head", "target_stds"): "not read (target_means)"},
    "FCOS": {("bbox_head", "strides"): "fixed: 8-128, as asked"},
    "RepPointsDetector": {
        ("bbox_head", "norm_cfg"): "vps_tpu's RepPointsHead has no GN: its "
                                   "towers are conv + ReLU"},
    "SingleStageDetector": {
        ("backbone", "depth"): "VGG-16 is the only SSDVGG",
        ("backbone", "with_last_pool"): "pool5 is SSD's 3x3 stride-1 pool, "
                                        "as asked",
        ("backbone", "ceil_mode"): "floor mode, as vps_tpu's pools: the "
                                   "levels are 37, 18, 9, 5, 3, 1 a side "
                                   "(8096 anchors, not 8732)",
        ("backbone", "out_indices"): "the levels are L2Norm(conv4_3), fc7 "
                                     "and the extras, as asked"},
}
# the losses vps_tpu's single-stage losses compute, by detector and key
_SINGLE_LOSSES = {
    "loss_cls": _FOCAL,
    "loss_bbox": dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0),
    ("FCOS", "loss_bbox"): dict(type="IoULoss", loss_weight=1.0),
    "loss_centerness": dict(type="CrossEntropyLoss", use_sigmoid=True,
                            loss_weight=1.0),
    "loss_bbox_init": dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                           loss_weight=0.5),
    "loss_bbox_refine": dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                             loss_weight=1.0),
}
# train_cfg notes a detector's config needs: what each reads
_SINGLE_TRAIN_NOTES = {
    "retinanet": ["train_cfg.assigner: vps_tpu's RetinaNet reads "
                  "pos_iou_thr, neg_iou_thr, min_pos_iou at train_cfg's top "
                  "level; its defaults 0.5, 0.4, 0 are the values asked"],
    "fcos": ["train_cfg.assigner: not read, FCOS assigns points by its "
             "regress ranges, as mmdet's FCOSHead"],
    "reppoints": ["train_cfg.init.assigner: vps_tpu reads init.scale and "
                  "init.pos_num, absent here: the head's point_base_scale "
                  "4 and 1, the values asked; refine.assigner read as "
                  "asked"],
    "ssd300": ["train_cfg.assigner.min_pos_iou=0. and gt_max_assign_all="
               "False: ssd_loss's fixed values, as asked"],
}


def _single_port_cfg(model):
    """The port's config of an mmdet single-stage model dict: ResNet's C3-C5
    into the FPN, the keys without a counterpart dropped, each listed with
    what the port does instead, and the losses it trains."""
    notes = ["pretrained: not loaded, seeded random weights (random_init_)"]
    kind = model["type"]
    dropped = {**_NECK_DROPPED, **_SINGLE_DROPPED[kind]}
    out = dict(model)
    out.pop("pretrained", None)
    if out.get("neck"):
        out["backbone"] = dict(out["backbone"], out_indices=(1, 2, 3))
        out["neck"] = dict(out["neck"], in_channels=[512, 1024, 2048])
        notes.append("backbone.out_indices=(0, 1, 2, 3), neck.in_channels="
                     "[256, 512, 1024, 2048]: (1, 2, 3) and [512, 1024, "
                     "2048], the C3-C5 the FPN reads")
    for where in ("backbone", "neck", "bbox_head"):
        if not out.get(where):
            continue
        d = dict(out[where])
        for key in sorted(d):
            if key.startswith("loss_"):
                spec = d.pop(key)
                fixed = _SINGLE_LOSSES.get((kind, key), _SINGLE_LOSSES[key])
                differ = {k: (spec.get(k), fixed.get(k))
                          for k in set(spec) | set(fixed)
                          if spec.get(k) != fixed.get(k)}
                notes.append(f"{where}.{key}: " + (
                    f"dropped: vps_tpu's loss is the one asked "
                    f"({spec['type']})" if not differ else
                    "dropped: the port trains vps_tpu's loss, which has "
                    + ", ".join(f"{k}={v[1]:.4g} where this config asks "
                                f"{v[0]}" for k, v in sorted(differ.items()))))
            elif (where, key) in dropped:
                d.pop(key)
                notes.append(f"{where}.{key}: {dropped[where, key]}")
        out[where] = d
    if kind == "SingleStageDetector":
        notes.append("bbox_head.in_channels: the backbone's levels', the "
                     "values asked; SingleStageDetector: the SSDHead picks "
                     "SSD")
    return out, notes


def _single_det(name, device, train=False):
    """``name``'s detector of single_stage_configs (with its train_cfg when
    ``train``), seeded random weights; returns it, the source config and
    the notes on keys without a counterpart."""
    from vps_torch.models.detectors import build_detector, random_init_

    source, model, train_cfg, test_cfg, _ = single_stage_configs()[name]
    cfg, notes = _single_port_cfg(model)
    det = random_init_(build_detector(
        cfg, train_cfg=train_cfg if train else None, test_cfg=test_cfg,
        device=device), seed=SEED)
    if train:
        notes = notes + _SINGLE_TRAIN_NOTES[name]
    return det, source, notes


def _single_sizes(name, sizes=None):
    """(hw, pad) of ``name``: its config's, or ``sizes`` for the R-50 ones
    (a CPU rehearsal's smaller image)."""
    hw, pad = single_stage_configs()[name][4]
    return (hw, pad) if sizes is None or name == "ssd300" else sizes


def phase_single_stage(smi, names=SINGLE_NAMES, device="cuda",
                       images=ZOO_IMAGES, sizes=None):
    """Each single-stage detector at full width with seeded weights on the
    seeded image (800x1333 padded to 800x1344; SSD300 300x300): 1 warm-up
    and ``images`` timed images, the checks of _zoo_check, one more image
    profiled by the named ranges (RepPoints' two DCNs a level in
    ``reppoints_dcn``). Fails on a port kernel launched. Returns the
    launch counts by path."""
    import torch

    paths = {}
    on_card = torch.device(device).type == "cuda"
    for name in names:
        hw, pad = _single_sizes(name, sizes)
        t0 = time.perf_counter()
        det, source, notes = _single_det(name, device)
        _sync(device)
        init_s = time.perf_counter() - t0
        img = _zoo_image(device, hw, pad)
        det.predict(img)  # warm-up
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        for _ in range(images):
            out = det.predict(img)
        _sync(device)
        ips = images / (time.perf_counter() - t0)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        nvalid = _zoo_check(name, out, det, *pad)
        label = f"single stage {name}"
        syncs = _zoo_profile(det, lambda: det.predict(img), SINGLE_STAGES,
                             label)
        print(f"{label}: {type(det).__name__} from mmdetection v1.0 "
              f"{source}, {_trunk(det)}, 81 classes, {hw[0]}x{hw[1]} padded "
              f"to {pad[0]}x{pad[1]}, init {init_s:.1f}s, {ips:.3f} images/s "
              f"over {images} images after 1 warm-up, peak mem "
              f"{peak / 2**30:.2f} GiB, valid detections {nvalid}, host "
              f"syncs an image {syncs}, launches {launches}; TF32 off; "
              f"card: {smi}")
        print(f"{label}: source keys without a counterpart: "
              + "; ".join(notes))
        if on_card and launches != _want():
            raise AssertionError(f"{label}: port kernel launches {launches}: "
                                 f"the single-stage paths run none of them")
        paths[label] = launches
        del det
    return paths


def phase_single_stage_train(smi, names=SINGLE_NAMES, device="cuda",
                             steps=SINGLE_TRAIN_STEPS, sizes=None):
    """Each single-stage detector trained at full width (_zoo_train_run's
    loop, train_policy, the port's Optimizer as the zoo's) on the seeded
    image and 12 seeded gt of 16 (SSD300 at 300x300). Returns the launch
    counts by path."""
    paths = {}
    for name in names:
        hw, pad = _single_sizes(name, sizes)
        label = f"single stage train {name}"
        launches, _ = _zoo_train_run(
            name, smi, device, hw=hw, pad=pad, steps=steps,
            make=lambda n, d: _single_det(n, d, train=True),
            stages=SINGLE_TRAIN_STAGES, label=label)
        paths[label] = launches
    return paths


def _tiny_single_cfgs():
    """tests/single_parity.py's tiny configs: R-18, a 32-wide FPN of five
    levels from stride 8, one conv a tower, 5 classes (FCOS 64 wide for
    GroupNorm(32)); SSD300 at its fixed widths."""
    trunk = dict(backbone=dict(type="ResNet", depth=18, frozen_stages=-1,
                               out_indices=(1, 2, 3)),
                 neck=dict(type="FPN", in_channels=(128, 256, 512),
                           out_channels=32, num_outs=5))
    head = dict(num_classes=5, in_channels=32, feat_channels=32,
                stacked_convs=1)
    return {
        "RetinaNet": dict(trunk, bbox_head=dict(head, type="RetinaHead")),
        "FCOS": dict(trunk, bbox_head=dict(head, type="FCOSHead",
                                           feat_channels=64)),
        "RepPointsDetector": dict(trunk, bbox_head=dict(
            head, type="RepPointsHead", point_feat_channels=32)),
        "SSD": dict(backbone=dict(type="SSDVGG", input_size=300),
                    bbox_head=dict(type="SSDHead", num_classes=5,
                                   input_size=300)),
    }


_TINY_SINGLE_TRAIN = {
    "RetinaNet": dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
    "FCOS": None,
    "RepPointsDetector": dict(init=dict(scale=4, pos_num=1), refine=dict(
        assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0))),
    "SSD": dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5),
                smoothl1_beta=1.0, neg_pos_ratio=3),
}


def _tiny_single_pair(kind, device, train=False):
    """The CPU detector (seeded weights; the saturating classifiers of
    RetinaNet, RepPoints and SSD x0.25, as phase_small_zoo's, so that
    probabilities do not tie in f32) and its copy on ``device``, and the
    seeded image (64x64; SSD 300x300) on the CPU."""
    import torch
    from vps_torch.models.detectors import build_detector, random_init_

    cfg = dict(_tiny_single_cfgs()[kind], type=kind)
    kw = dict(test_cfg=dict(nms_pre=40, score_thr=0.02, max_per_img=20),
              train_cfg=_TINY_SINGLE_TRAIN[kind] if train else None)
    cpu = random_init_(build_detector(cfg, device="cpu", **kw), seed=SEED + 1)
    with torch.no_grad():
        for n, m in cpu.named_modules():
            if isinstance(m, torch.nn.Conv2d) and re.search(
                    r"retina_cls$|reppoints_cls_out$|^bbox_head\.cls_convs\."
                    r"\d+$", n):
                m.weight.mul_(0.25)
    gpu = build_detector(cfg, device=device, **kw)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    side = 300 if kind == "SSD" else 64
    rng = np.random.RandomState(SEED + 13)
    img = torch.from_numpy(rng.randn(1, side, side, 3).astype(np.float32))
    return cpu, gpu, img


def phase_small_single_stage(device="cuda"):
    """The four single-stage detectors at the CPU tests' tiny shapes on one
    seeded image: the card against the port's CPU path with the same
    weights, under phase_small_zoo's bars (equal det_valid and det_labels,
    boxes and scores within 2e-2, at least one detection)."""
    for kind in _tiny_single_cfgs():
        cpu, gpu, img = _tiny_single_pair(kind, device)
        want = cpu.predict(img)
        got = {k: v.cpu() for k, v in gpu.predict(img.to(device)).items()}
        same = all(np.array_equal(got[k].numpy(), want[k].numpy())
                   for k in ("det_valid", "det_labels"))
        err = float((got["det_bboxes"] - want["det_bboxes"]).abs().max())
        n = int(want["det_valid"].sum())
        print(f"small single stage: {kind} card vs cpu: dets {n} "
              f"{'equal' if same else 'DIFFER'}, box/score max err "
              f"{err:.2e} (tol 2e-2)")
        if not same or n == 0 or err > 2e-2:
            raise AssertionError(f"small single stage {kind} disagrees "
                                 f"between card and cpu")


def _single_choices(kind):
    """(module, attribute, what to keep of its result) of each assignment
    ``kind``'s loss makes, in call order."""
    import vps_torch.models.anchor_heads as heads
    import vps_torch.models.detectors.single_stage as single
    import vps_torch.models.reppoints as reppoints

    def inds(r):
        return r.assigned_gt_inds

    return {"RetinaNet": [(single, "max_iou_assign", inds)],
            "FCOS": [(heads, "fcos_target", lambda r: r[0])],
            "RepPointsDetector": [(reppoints, "point_assign", inds),
                                  (reppoints, "max_iou_assign", inds)],
            "SSD": [(heads, "max_iou_assign", inds),
                    (heads, "hard_negatives", lambda r: r)]}[kind]


def phase_small_single_stage_train(device="cuda"):
    """The four single-stage detectors' loss at the tiny shapes, one step on
    the card against the CPU path, the same weights and gt, both under
    train_policy: every assignment (MaxIoU, point, FCOS's targets, SSD's
    kept hard negatives) equal, every term within rel 1e-3 and every
    gradient within SMALL_ZOO_GRAD_TOL of the tensor's largest. SSD300's
    VGG convs through conv5_3 are held in a float64 run on both sides
    (f32 rounding flips the sign of a few of their ~10M pre-activations
    near zero, which moves their gradients by up to ~1e-2; the rest of its
    f32 gradients are held as they are)."""
    import torch
    from vps_torch.utils.numerics import train_policy

    boxes = np.asarray([[4, 4, 28, 30], [30, 8, 60, 40], [10, 34, 40, 60],
                        [0, 0, 0, 0]], np.float32)
    gt = dict(gt_labels=np.asarray([1, 2, 4, 0], np.int32),
              gt_valid=np.asarray([1, 1, 1, 0], bool))
    for kind in _tiny_single_cfgs():
        cpu, gpu, img = _tiny_single_pair(kind, device, train=True)
        scale = np.float32(300 / 64) if kind == "SSD" else np.float32(1)
        runs = {}
        for dev, det, dt in (("cpu", cpu, torch.float32),
                             ("card", gpu, torch.float32),
                             ("cpu64", cpu, torch.float64),
                             ("card64", gpu, torch.float64)):
            if dt == torch.float64:
                if kind != "SSD":
                    continue
                det = copy.deepcopy(det).double()
            det.zero_grad(set_to_none=True)
            sel = []
            saved = []
            for mod, attr, pick in _single_choices(kind):
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))

                def wrapped(*a, _fn=fn, _pick=pick, **k):
                    res = _fn(*a, **k)
                    sel.append(_pick(res).cpu())
                    return res

                setattr(mod, attr, wrapped)
            args = {k: torch.from_numpy(v).to(det.device)
                    for k, v in gt.items()}
            args["gt_bboxes"] = torch.from_numpy(boxes * scale).to(
                det.device, dt)
            try:
                with train_policy():
                    losses = det.loss(img.to(det.device, dt), **args)
                    sum(losses.values()).backward()
            finally:
                for mod, attr, fn in saved:
                    setattr(mod, attr, fn)
            runs[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                         {n: p.grad.cpu().double()
                          for n, p in det.named_parameters()
                          if p.grad is not None}, sel)
        (want, gw, ws), (got, gg, gs) = runs["cpu"], runs["card"]
        same_sel = len(ws) == len(gs) > 0 and all(
            torch.equal(a, b) for a, b in zip(ws, gs))
        rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())

        def worst(a, b, names):
            gmax = max(float(g.abs().max()) for g in a.values())
            return max(float((b[n] - a[n]).abs().max())
                       / (float(a[n].abs().max())
                          + 1e-6 * gmax / SMALL_ZOO_GRAD_TOL) for n in names)

        trunk = {n for n in gw if n.startswith("backbone.features.")}
        gerr = worst(gw, gg, set(gw) - trunk)
        line = (f"small single stage train: {kind} card vs cpu: "
                f"{len(want)} terms, worst rel err {rel:.2e} (tol 1e-3), "
                f"assignments {len(ws)} {'equal' if same_sel else 'DIFFER'}, "
                f"{len(gw) - len(trunk)} gradients worst err {gerr:.2e} of "
                f"the tensor's largest (tol {SMALL_ZOO_GRAD_TOL:g})")
        if trunk:
            g64 = worst(runs["cpu64"][1], runs["card64"][1], trunk)
            f32 = worst(gw, gg, trunk)
            line += (f"; VGG's {len(trunk)} conv gradients in float64 "
                     f"{g64:.2e} (tol {SMALL_ZOO_GRAD_TOL:g}), in f32 "
                     f"{f32:.2e} (not a gate)")
            gerr = max(gerr, g64)
        print(line)
        if (set(got) != set(want) or not same_sel or rel > 1e-3
                or set(gg) != set(gw) or gerr > SMALL_ZOO_GRAD_TOL):
            raise AssertionError(f"small single stage train {kind} disagrees "
                                 f"between card and cpu")


def _repeat_steps(label, det, step, make_opt, seed=SEED):
    """Two train steps of ``det`` from the same weights, optimizer state
    (after one warm-up step: momentum set) and generator seed, under
    train_policy, compared bit for bit: every loss term and every
    parameter after the update. Where they part, the first module whose
    output differs in two forwards (every module hooked), else the first
    parameter whose gradient differs; then fails. ``step(opt, gen)`` runs
    one step and returns the loss dict. Returns the optimizer."""
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
                           zoo_hw=ZOO_HW, zoo_pad=ZOO_PAD, cost_steps=1):
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


# ---------------------------------------------------------------------------
# Guided anchoring: GA-RetinaNet and GA-RPN at full width, their training,
# and the tiny heads of the CPU tests on the card against the CPU
# ---------------------------------------------------------------------------

GA_NAMES = ("ga_retinanet", "ga_rpn")
GA_IMAGES = 2  # timed, after 1 warm-up
GA_TRAIN_STEPS = 2  # 1 warm-up + 1 timed
GA_STAGES = ("backbone_fpn", "ga_head", "feature_adaption", "ga_dets",
             "ga_proposals")
_CAFFE_R50 = dict(type="ResNet", depth=50, num_stages=4,
                  out_indices=(0, 1, 2, 3), frozen_stages=1,
                  norm_cfg=dict(type="BN", requires_grad=False),
                  norm_eval=True, style="caffe")
_GA_LOC = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
               loss_weight=1.0)
_GA_SHAPE = dict(type="BoundedIoULoss", beta=0.2, loss_weight=1.0)
_GA_SAMPLER = dict(type="RandomSampler", num=256, pos_fraction=0.5,
                   neg_pos_ub=-1, add_gt_as_proposals=False)


def ga_configs():
    """{name: (source config, model dict, train_cfg, test_cfg)}, written
    from mmdetection v1.0's configs/guided_anchoring/ as zoo_configs."""
    def ga_assigner(pos, neg, min_pos):
        return dict(type="ApproxMaxIoUAssigner", pos_iou_thr=pos,
                    neg_iou_thr=neg, min_pos_iou=min_pos, ignore_iof_thr=-1)

    def head(**kw):
        return dict(kw, in_channels=256, feat_channels=256,
                    scales_per_octave=3, octave_ratios=[0.5, 1.0, 2.0],
                    anchor_base_sizes=None, anchoring_means=[.0, .0, .0, .0],
                    target_means=(.0, .0, .0, .0), loc_filter_thr=0.01,
                    loss_loc=_GA_LOC, loss_shape=_GA_SHAPE)

    return {
        "ga_retinanet": ("configs/guided_anchoring/ga_retinanet_r50_caffe_fpn_"
                         "1x.py", dict(
            type="RetinaNet", pretrained="open-mmlab://resnet50_caffe",
            backbone=_CAFFE_R50,
            neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                      out_channels=256, start_level=1, add_extra_convs=True,
                      num_outs=5),
            bbox_head=head(
                type="GARetinaHead", num_classes=81, stacked_convs=4,
                octave_base_scale=4, anchor_strides=[8, 16, 32, 64, 128],
                anchoring_stds=[1.0, 1.0, 1.0, 1.0],
                target_stds=[1.0, 1.0, 1.0, 1.0], loss_cls=_FOCAL,
                loss_bbox=dict(type="SmoothL1Loss", beta=0.04,
                               loss_weight=1.0))),
            dict(ga_assigner=ga_assigner(0.5, 0.4, 0.4),
                 ga_sampler=_GA_SAMPLER,
                 assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                               neg_iou_thr=0.5, min_pos_iou=0.0,
                               ignore_iof_thr=-1),
                 allowed_border=-1, pos_weight=-1, center_ratio=0.2,
                 ignore_ratio=0.5, debug=False),
            dict(nms_pre=1000, min_bbox_size=0, score_thr=0.05,
                 nms=dict(type="nms", iou_thr=0.5), max_per_img=100)),
        "ga_rpn": ("configs/guided_anchoring/ga_rpn_r50_caffe_fpn_1x.py", dict(
            type="RPN", pretrained="open-mmlab://resnet50_caffe",
            backbone=_CAFFE_R50,
            neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                      out_channels=256, num_outs=5),
            rpn_head=head(
                type="GARPNHead", octave_base_scale=8,
                anchor_strides=[4, 8, 16, 32, 64],
                anchoring_stds=[0.07, 0.07, 0.14, 0.14],
                target_stds=[0.07, 0.07, 0.11, 0.11],
                loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True,
                              loss_weight=1.0),
                loss_bbox=dict(type="SmoothL1Loss", beta=1.0,
                               loss_weight=1.0))),
            dict(rpn=dict(ga_assigner=ga_assigner(0.7, 0.3, 0.3),
                          ga_sampler=_GA_SAMPLER,
                          assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                                        neg_iou_thr=0.3, min_pos_iou=0.3,
                                        ignore_iof_thr=-1),
                          sampler=dict(_GA_SAMPLER), allowed_border=-1,
                          pos_weight=-1, center_ratio=0.2, ignore_ratio=0.5,
                          debug=False)),
            dict(rpn=dict(nms_across_levels=False, nms_pre=2000,
                          nms_post=2000, max_num=300, nms_thr=0.7,
                          min_bbox_size=0))),
    }


# the losses vps_tpu's ga_loss / ga_rpn_loss compute, by head key
_GA_LOSSES = {
    "loss_loc": _GA_LOC, "loss_shape": _GA_SHAPE,
    ("bbox_head", "loss_cls"): _FOCAL,
    ("bbox_head", "loss_bbox"): dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                                     loss_weight=1.0),
    ("rpn_head", "loss_cls"): dict(type="CrossEntropyLoss", use_sigmoid=True,
                                   loss_weight=1.0),
    ("rpn_head", "loss_bbox"): dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                                    loss_weight=1.0),
}
# config keys the GA functions (as vps_tpu's) have no argument for, and
# what the port does instead
_GA_DROPPED = {
    ("backbone", "norm_eval"): "FrozenBatchNorm, whose statistics never "
                               "update, as asked",
    ("head", "anchor_base_sizes"): "None: the base sizes are the strides, "
                                   "as vps_tpu's generators take them",
    ("head", "type"): "the head's class (HEADS), on the port's backbone and "
                      "FPN; no detector of vps_tpu (or the port) builds the "
                      "GA heads, so this script composes them",
}
_GA_TRAIN_NOTES = {
    "ga_retinanet": ["train_cfg.allowed_border=-1: not read, ga_loss "
                     "assigns every guided anchor (what -1 asks)",
                     "train_cfg.ga_sampler.type=RandomSampler: "
                     "ga_shape_targets' random_sample, as asked"],
    "ga_rpn": ["train_cfg.rpn.allowed_border=-1: vps_tpu's anchor_target "
               "reads it as a border of -1 px (a guided anchor within 1 px "
               "of the edge is not assigned), where mmdet reads a negative "
               "border as no filter",
               "train_cfg.rpn.ga_sampler.type=RandomSampler: "
               "ga_shape_targets' random_sample, as asked"],
}


def _ga_port_cfg(model, train_cfg, test_cfg):
    """The port's backbone, neck and head configs of a GA model dict
    (ResNet's C3-C5 into the FPN where the config starts at level 1), the
    keys without a counterpart dropped, each listed with what the port does
    instead."""
    notes = ["pretrained: not loaded, seeded random weights (random_init_)"]
    key = "rpn_head" if "rpn_head" in model else "bbox_head"
    backbone, neck, head = (dict(model[k]) for k in ("backbone", "neck",
                                                     key))
    notes.append(f"type={model['type']}: {_GA_DROPPED['head', 'type']}")
    head.pop("type")
    for k in ("norm_cfg", "norm_eval"):
        backbone.pop(k)
        notes.append(f"backbone.{k}: " + (_NO_COUNTERPART[k] if k in
                                          _NO_COUNTERPART else
                                          _GA_DROPPED["backbone", k]))
    if neck.pop("start_level", 0) == 1:
        backbone["out_indices"] = (1, 2, 3)
        neck["in_channels"] = [512, 1024, 2048]
        notes.append("neck.start_level=1: " + _NECK_DROPPED["neck",
                                                            "start_level"])
    if "add_extra_convs" in neck:
        neck.pop("add_extra_convs")
        notes.append("neck.add_extra_convs: " + _NECK_DROPPED[
            "neck", "add_extra_convs"])
    head.pop("anchor_base_sizes")
    notes.append(f"{key}.anchor_base_sizes: "
                 + _GA_DROPPED["head", "anchor_base_sizes"])
    for k in sorted(k for k in head if k.startswith("loss_")):
        spec = head.pop(k)
        fixed = _GA_LOSSES.get(k) or _GA_LOSSES[key, k]
        differ = {a: (spec.get(a), fixed.get(a)) for a in set(spec) | set(fixed)
                  if spec.get(a) != fixed.get(a)}
        notes.append(f"{key}.{k}: " + (
            f"dropped: vps_tpu's loss is the one asked ({spec['type']})"
            if not differ else "dropped: the port trains vps_tpu's loss, "
            "which has " + ", ".join(f"{a}={v[1]:.4g} where this config "
                                     f"asks {v[0]}"
                                     for a, v in sorted(differ.items()))))
    notes += _zoo_train_notes(train_cfg)
    if "rpn" in test_cfg:
        notes += ["rpn.nms_across_levels=False: per-level NMS, as read",
                  f"rpn.nms_post={test_cfg['rpn']['nms_post']}: not read "
                  f"(each level keeps <= nms_pre after its NMS)"]
    else:
        notes.append("min_bbox_size=0: ga_bboxes has no such argument; 0 "
                     "filters nothing")
    return dict(backbone=backbone, neck=neck, head=head), key, notes


def _ga_model(name, device):
    """``name``'s model of ga_configs: the port's backbone and FPN (through
    their registries) under its GA head (HEADS), seeded random weights
    (random_init_, which gives the loc convs the prior bias). ``predict``
    runs the masked forward and ga_bboxes / ga_rpn_proposals; ``loss``
    ga_loss / ga_rpn_loss; in the named ranges backbone_fpn, ga_head
    (feature_adaption inside), ga_dets / ga_proposals, ga_loss. Returns
    (model, source, notes)."""
    import torch
    from vps_torch.models import ga_heads
    from vps_torch.models.detectors import random_init_
    from vps_torch.registry import BACKBONES, HEADS, NECKS, build_from_cfg

    stage = torch.profiler.record_function
    source, model, train_cfg, test_cfg = ga_configs()[name]
    cfg, key, notes = _ga_port_cfg(model, train_cfg, test_cfg)
    rpn = key == "rpn_head"
    dev = torch.device(device)
    head_type = model[key]["type"]

    class GAModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.device = dev
            self.test_cfg = test_cfg
            self.backbone = build_from_cfg(cfg["backbone"], BACKBONES,
                                           dict(device=dev))
            self.neck = build_from_cfg(cfg["neck"], NECKS, dict(device=dev))
            setattr(self, key, build_from_cfg(dict(cfg["head"],
                                                   type=head_type), HEADS,
                                              dict(device=dev)))
            self.eval()  # frozen BN

        def forward(self, img, masked):
            head = getattr(self, key)
            with stage("backbone_fpn"):
                x = self.neck(self.backbone(img.permute(0, 3, 1, 2)))
            with stage("ga_head"):
                return head(x, masked=masked)

        @torch.inference_mode()
        def predict(self, img):
            head = getattr(self, key)
            outs = self(img, masked=True)
            thr = head.loc_filter_thr
            kept = torch.stack([(torch.sigmoid(lp) >= thr).float().mean()
                                for lp in outs[3]])
            hw = tuple(img.shape[1:3])
            if rpn:
                t = test_cfg["rpn"]
                with stage("ga_proposals"):
                    p, s, v = ga_heads.ga_rpn_proposals(
                        head, *outs, hw, nms_pre=t["nms_pre"],
                        nms_thr=t["nms_thr"], max_num=t["max_num"],
                        min_bbox_size=t["min_bbox_size"])
                return {"proposals": p, "scores": s, "proposal_valid": v,
                        "loc_kept": kept}
            t = test_cfg
            with stage("ga_dets"):
                d, lab, v = ga_heads.ga_bboxes(
                    head, *outs, hw, nms_pre=t["nms_pre"],
                    score_thr=t["score_thr"], nms_thr=t["nms"]["iou_thr"],
                    max_per_img=t["max_per_img"])
            return {"det_bboxes": d, "det_labels": lab, "det_valid": v,
                    "loc_kept": kept}

        def loss(self, img, gt_bboxes, gt_valid, gt_labels=None,
                 generator=None):
            head = getattr(self, key)
            outs = self(img, masked=False)
            hw = tuple(img.shape[1:3])
            with stage("ga_loss"):
                if rpn:
                    return ga_heads.ga_rpn_loss(generator, head, *outs,
                                                gt_bboxes, gt_valid, hw,
                                                train_cfg["rpn"])
                return ga_heads.ga_loss(generator, head, *outs, gt_bboxes,
                                        gt_labels, gt_valid, hw, train_cfg)

    return random_init_(GAModel(), seed=SEED), source, notes


def _ga_head_line(m):
    """The head's full-width settings, for the phase lines."""
    head = m.rpn_head if hasattr(m, "rpn_head") else m.bbox_head
    fa = [x for x in head.modules()
          if type(x).__name__ == "FeatureAdaption"]
    return (f"{type(head).__name__} (num_classes {head.num_classes}), "
            f"strides {list(head.anchor_strides)}, "
            f"{len(fa)} feature adaption(s) a level of "
            f"{fa[0].conv_adaption.weight.shape[0]} channels, deformable "
            f"groups {head.deformable_groups}, loc_filter_thr "
            f"{head.loc_filter_thr}")


def phase_ga(smi, names=GA_NAMES, device="cuda", images=GA_IMAGES,
             hw=ZOO_HW, pad=ZOO_PAD):
    """GA-RetinaNet and GA-RPN at full width (caffe R-50, 256-wide FPN, 81
    classes, 4 deformable groups) with seeded weights on the zoo's seeded
    image (800x1333 padded to 800x1344), under inference_policy: 1 warm-up
    and ``images`` timed images of the masked forward and decode, the
    zoo's checks, the share of locations the loc filter keeps per level,
    one more image profiled by the named ranges. Fails on a port kernel
    launched. Returns the launch counts by path."""
    import torch
    from vps_torch.utils.numerics import inference_policy

    paths = {}
    on_card = torch.device(device).type == "cuda"
    for name in names:
        label = f"ga {name}"
        with inference_policy():
            t0 = time.perf_counter()
            m, source, notes = _ga_model(name, device)
            _sync(device)
            init_s = time.perf_counter() - t0
            img = _zoo_image(device, hw, pad)
            m.predict(img)  # warm-up
            _sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            for _ in range(images):
                out = m.predict(img)
            _sync(device)
            ips = images / (time.perf_counter() - t0)
            launches = _counts()
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            nvalid = _zoo_check(label, out, m, *pad)
            kept = out["loc_kept"].tolist()
            syncs = _zoo_profile(m, lambda: m.predict(img), GA_STAGES, label)
        what = "proposals" if "proposals" in out else "valid detections"
        print(f"{label}: from mmdetection v1.0 {source}, {_trunk(m)}, "
              f"{_ga_head_line(m)}, {hw[0]}x{hw[1]} padded to "
              f"{pad[0]}x{pad[1]}, init {init_s:.1f}s, {ips:.3f} images/s "
              f"over {images} images after 1 warm-up, peak mem "
              f"{peak / 2**30:.2f} GiB, {what} {nvalid}, host syncs an image "
              f"{syncs}, loc filter keeps per level "
              f"{', '.join(f'{k:.4f}' for k in kept)}, launches {launches}; "
              f"inference_policy, TF32 off; card: {smi}")
        print(f"{label}: source keys without a counterpart: "
              + "; ".join(notes))
        if not all(np.isfinite(kept)):
            raise AssertionError(f"{label}: loc shares {kept}")
        if on_card and launches != _want():
            raise AssertionError(f"{label}: port kernel launches {launches}: "
                                 f"the GA paths run none of them")
        paths[label] = launches
        del m
    return paths


def phase_ga_train(smi, names=GA_NAMES, device="cuda", steps=GA_TRAIN_STEPS,
                   hw=ZOO_HW, pad=ZOO_PAD):
    """GA-RetinaNet's ga_loss and GA-RPN's ga_rpn_loss trained at full width
    (_zoo_train_run's loop: train_policy, the port's Optimizer, 12 seeded gt
    of 16, 1 warm-up + 2 timed steps, no profiled step). Fails on a
    non-finite term, a trainable head parameter without a gradient, a
    frozen parameter that changed. Returns the launch counts by path."""
    import torch

    def make(name, dev):
        m, source, notes = _ga_model(name, dev)
        return m, source, notes + _GA_TRAIN_NOTES[name]

    def head_grads(m):
        head = m.rpn_head if hasattr(m, "rpn_head") else m.bbox_head
        none = [n for n, p in head.named_parameters() if p.grad is None]
        zero = [n for n, p in head.named_parameters()
                if p.grad is not None and not bool(p.grad.any())]
        print(f"{label}: head parameters {len(list(head.parameters()))}, "
              f"without a gradient {none}, with an all-zero one {zero}")
        if none:
            raise AssertionError(f"{label}: no gradient for {none}")

    paths = {}
    for name in names:
        label = f"ga train {name}"
        launches, m = _zoo_train_run(name, smi, device, hw=hw, pad=pad,
                                     steps=steps, make=make, stages=None,
                                     label=label, on_grads=head_grads)
        paths[label] = launches
        del m
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return paths


# tests/ga_parity.py's tiny heads: 3 levels of 32 channels at strides 8-32,
# 2 deformable groups, the loc filter at 0.5 (about half kept)
_TINY_GA = {"GuidedAnchorHead": dict(num_classes=5), "GARPNHead": {},
            "GARetinaHead": dict(num_classes=5, stacked_convs=2)}
_TINY_GA_KW = dict(in_channels=32, feat_channels=32, anchor_strides=(8, 16, 32),
                   deformable_groups=2, loc_filter_thr=0.5)
_TINY_GA_GT = dict(gt_bboxes=np.asarray([[8, 8, 120, 100], [40, 20, 90, 60],
                                         [44, 24, 100, 70], [0, 0, 0, 0]],
                                        np.float32),
                   gt_labels=np.asarray([2, 3, 1, 0], np.int32),
                   gt_valid=np.asarray([True, True, True, False]))
_TINY_GA_CFG = dict(ga_assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.3),
                    assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4),
                    center_ratio=0.2, ignore_ratio=0.5,
                    ga_sampler=dict(num=64, pos_fraction=0.5))
_TINY_GA_RPN_CFG = dict(_TINY_GA_CFG, assigner=dict(
    pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3),
    sampler=dict(num=64, pos_fraction=0.5), allowed_border=0)
_TINY_GA_SHAPE = (128, 256)


def _tiny_ga_pair(kind, device):
    """The CPU head with seeded weights (kernels N(0, 1 / fan_in), biases
    N(0, 0.02^2), as the CPU tests' fill), its copy on ``device``, and the
    CPU tests' seeded levels (1, 32, H, W) on the CPU."""
    import torch
    from vps_torch.models import ga_heads

    cpu = getattr(ga_heads, kind)(**_TINY_GA[kind], **_TINY_GA_KW,
                                  device="cpu")
    gen = torch.Generator().manual_seed(SEED + 17)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            z = torch.randn(p.shape, generator=gen)
            p.copy_(z * 0.02 if n.endswith("bias")
                    else z / np.sqrt(p[0].numel()))
    card = getattr(ga_heads, kind)(**_TINY_GA[kind], **_TINY_GA_KW,
                                   device=device)
    card.load_state_dict(cpu.state_dict(), strict=True)
    feats = [torch.from_numpy(np.random.RandomState(i).randn(
        1, 16 >> i, 32 >> i, 32).astype(np.float32)).permute(0, 3, 1, 2)
        for i in range(3)]
    return cpu, card, feats


# the tiny decode's boxes, card against CPU: the maps differ by ~1e-6 (f32
# sums in other orders; 1.3e-6 measured on an H100), which the decode's
# exp scales by box sizes up to 256 px: 1.37e-4 measured at 1e-4 flat
SMALL_GA_RTOL = 1e-5


def phase_small_ga(device="cuda"):
    """The three GA heads at the CPU tests' tiny shapes, the masked forward
    and the decode (ga_bboxes; GARPNHead's ga_rpn_proposals) on the card
    against the port's CPU path with the same weights: equal validity and
    labels (zoo_parity.assert_dets_match's sets), boxes and scores within
    its 1e-4 plus SMALL_GA_RTOL of the value."""
    import torch
    from vps_torch.models import ga_heads
    from vps_torch.utils.numerics import inference_policy

    for kind in _TINY_GA:
        cpu, card, feats = _tiny_ga_pair(kind, device)
        res = {}
        for dev, head in (("cpu", cpu), ("card", card)):
            with inference_policy(), torch.no_grad():
                outs = head([f.to(dev if dev == "cpu" else device)
                             for f in feats], masked=True)
                if kind == "GARPNHead":
                    r = ga_heads.ga_rpn_proposals(head, *outs, _TINY_GA_SHAPE,
                                                  nms_pre=200, max_num=100)
                else:
                    r = ga_heads.ga_bboxes(head, *outs, _TINY_GA_SHAPE,
                                           nms_pre=200, max_per_img=30)
            res[dev] = ([t.cpu() for t in r],
                        [t.cpu() for lvl in outs for t in lvl])
        (want, wmaps), (got, gmaps) = res["cpu"], res["card"]
        if kind == "GARPNHead":
            boxes, valid = (0, 1), 2
            same = torch.equal(got[valid], want[valid])
        else:
            boxes, valid = (0,), 2
            same = torch.equal(got[2], want[2]) and torch.equal(got[1],
                                                                want[1])
        err = max(float(((got[i] - want[i]).abs()
                          / (1e-4 + SMALL_GA_RTOL * want[i].abs())).max())
                  for i in boxes)
        merr = max(float((g - w).abs().max()) for g, w in zip(gmaps, wmaps))
        n = int(want[valid].sum())
        print(f"small ga: {kind} card vs cpu: {n} valid "
              f"{'equal' if same else 'DIFFER'}, box/score max err "
              f"{err:.3f} of 1e-4 + {SMALL_GA_RTOL:g} x value (tol 1), "
              f"masked maps max err {merr:.2e}")
        if not same or n < 3 or err > 1:
            raise AssertionError(f"small ga {kind} disagrees between card "
                                 f"and cpu")


def _small_ga_ops(device):
    """The six losses (value and autograd gradient) and masked_conv2d at
    GA-RetinaNet's training sizes (its 22400 squares; 80 classes) on the
    card against the CPU: values within rel 1e-4, gradients and outputs
    within 1e-4 of their largest. The GHM losses weigh each element by its
    bin's count: an element whose gradient norm g lies within 1e-6 of a bin
    edge may fall in the next bin on the card (sigmoid and sqrt differ there
    by an ulp) and take another weight, so such elements (at most 1e-4 of
    them) are counted and left out of the gradient's comparison, as the
    CPU tests leave out a loc score within 1e-6 of its threshold; the
    value is held whole."""
    import torch
    import vps_torch.ops.losses as L
    from vps_torch.ops.masked_conv import masked_conv2d

    rng = np.random.RandomState(SEED + 18)
    n = 22400
    xy = rng.uniform(0, 1200, (n, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 400, (n, 2))], 1)
    boxes = gt + rng.normal(scale=10.0, size=(n, 4))
    w = (rng.uniform(size=n) > 0.5).astype(np.float32)
    d4 = rng.normal(size=(n, 4))
    cases = {
        "mse_loss": (d4, (rng.normal(size=(n, 4)),),
                     dict(weight=w[:, None], avg_factor=np.float32(100))),
        "balanced_l1_loss": (d4, (rng.normal(size=(n, 4)),),
                             dict(weight=w[:, None],
                                  avg_factor=np.float32(100))),
        "bounded_iou_loss": (boxes, (gt,), dict(weight=w,
                                                avg_factor=np.float32(100))),
        "giou_loss": (boxes, (gt,), dict(weight=w,
                                         avg_factor=np.float32(100))),
        "ghm_c_loss": (rng.normal(scale=3.0, size=(n, 80)),
                       (rng.randint(0, 81, n), rng.uniform(size=n) > 0.1),
                       {}),
        "ghm_r_loss": (rng.normal(scale=0.05, size=(n, 4)),
                       (rng.normal(scale=0.05, size=(n, 4)),
                        rng.uniform(size=n) > 0.1), {}),
    }
    worst = []
    for name, (x, args, kw) in cases.items():
        out = {}
        for dev in ("cpu", device):
            def t(a):
                a = torch.from_numpy(np.asarray(a))
                return (a.float() if a.is_floating_point() else a).to(dev)

            tx = t(x).requires_grad_(True)
            val = getattr(L, name)(tx, *(t(a) for a in args),
                                   **{k: t(v) for k, v in kw.items()})
            val.backward()
            out[dev] = (float(val.detach()), tx.grad.cpu())
        (wv, wg), (gv, gg) = out["cpu"], out[device]
        rel = abs(gv - wv) / max(abs(wv), 1e-12)
        far = torch.ones_like(wg, dtype=torch.bool)
        if name.startswith("ghm"):
            xc = torch.from_numpy(np.asarray(x)).float()
            if name == "ghm_c_loss":
                t = torch.nn.functional.one_hot(torch.from_numpy(args[0]),
                                                81)[:, 1:].float()
                g = (torch.sigmoid(xc) - t).abs()
                edges = L._ghm_edges(10, 1e-6, "cpu")
            else:
                d = xc - torch.from_numpy(args[0]).float()
                g = (d / torch.sqrt(d * d + 0.02 * 0.02)).abs()
                edges = L._ghm_edges(10, 1e3, "cpu")
            far = (g[..., None] - edges).abs().min(-1).values > 1e-6
        near = int((~far).sum())
        gerr = (float((gg - wg)[far].abs().max())
                / float(wg[far].abs().max()))
        worst.append((name, rel, gerr, near))
        if rel > 1e-4 or gerr > 1e-4 or near > 1e-4 * far.numel():
            raise AssertionError(f"small ga ops: {name} card vs cpu: value "
                                 f"rel {rel:.2e}, gradient {gerr:.2e}, "
                                 f"{near} elements near a bin edge")
    x = rng.normal(size=(1, 100, 168, 256)).astype(np.float32)
    mask = rng.uniform(size=(1, 100, 168)) > 0.5
    wt = (rng.normal(size=(80, 256, 3, 3)) / 48).astype(np.float32)
    b = rng.normal(size=80).astype(np.float32)
    outs = [masked_conv2d(*(torch.from_numpy(a).to(dev)
                            for a in (x, mask, wt, b))).cpu()
            for dev in ("cpu", device)]
    merr = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
    print("small ga ops: card vs cpu at GA-RetinaNet's training sizes: "
          + ", ".join(f"{k} value rel {r:.2e}, gradient {g:.2e}"
                      + (f" ({n} elements within 1e-6 of a bin edge left "
                         f"out)" if k.startswith("ghm") else "")
                      for k, r, g, n in worst)
          + f" (tol 1e-4); masked_conv2d (1, 100, 168, 256) -> 80 3x3 "
          f"{merr:.2e} of its largest (tol 1e-4)")
    if merr > 1e-4:
        raise AssertionError("small ga ops: masked_conv2d disagrees")


def phase_small_ga_train(device="cuda"):
    """The three GA heads' loss (ga_loss; GARPNHead's ga_rpn_loss) one step
    at the CPU tests' tiny shapes, the card against the CPU with the same
    weights, gt and injected draws, both under train_policy: every approx
    and MaxIoU assignment and sampled set equal, every term within rel
    1e-3, every gradient within SMALL_ZOO_GRAD_TOL of its tensor's largest;
    then the six losses and masked_conv2d at training sizes
    (_small_ga_ops)."""
    import torch
    import vps_torch.core.sampler as tsampler
    import vps_torch.core.targets as ttargets
    from vps_torch.models import ga_heads
    from vps_torch.utils.numerics import train_policy

    wrapped = [(ga_heads, "approx_max_iou_assign"),
               (ga_heads, "max_iou_assign"), (ttargets, "max_iou_assign"),
               (ga_heads, "random_sample"), (ttargets, "random_sample")]
    saved = [(m, a, getattr(m, a)) for m, a in wrapped] + [
        (tsampler, "uniform", tsampler.uniform)]
    for kind in _TINY_GA:
        cpu, card, feats = _tiny_ga_pair(kind, device)
        runs = {}
        for dev, head in (("cpu", cpu), ("card", card)):
            calls, sel = [0], []

            def feed(gen, shape, device):
                calls[0] += 1
                r = np.random.RandomState(100 + calls[0]).rand(*shape)
                return torch.from_numpy(r.astype(np.float32)).to(device)

            def record(fn):
                def run(*a, **k):
                    res = fn(*a, **k)
                    sel.append((res.inds.cpu(), res.valid.cpu())
                               if hasattr(res, "inds") else
                               (res.assigned_gt_inds.cpu(), None))
                    return res
                return run

            d = torch.device("cpu") if dev == "cpu" else torch.device(device)
            gt = {k: torch.from_numpy(v).to(d) for k, v in _TINY_GA_GT.items()}
            for m, a, fn in saved[:-1]:
                setattr(m, a, record(fn))
            tsampler.uniform = feed
            try:
                with train_policy():
                    outs = head([f.to(d) for f in feats])
                    if kind == "GARPNHead":
                        losses = ga_heads.ga_rpn_loss(
                            None, head, *outs, gt["gt_bboxes"],
                            gt["gt_valid"], _TINY_GA_SHAPE, _TINY_GA_RPN_CFG)
                    else:
                        losses = ga_heads.ga_loss(
                            None, head, *outs, gt["gt_bboxes"],
                            gt["gt_labels"], gt["gt_valid"], _TINY_GA_SHAPE,
                            _TINY_GA_CFG)
                    sum(losses.values()).backward()
            finally:
                for m, a, fn in saved:
                    setattr(m, a, fn)
            runs[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                         {n: p.grad.cpu() for n, p in head.named_parameters()
                          if p.grad is not None}, sel)
        (want, gw, ws), (got, gg, gs) = runs["cpu"], runs["card"]

        def same(a, b):
            if a[1] is None:
                return b[1] is None and torch.equal(a[0], b[0])
            return (torch.equal(a[1], b[1])
                    and torch.equal(a[0][a[1]], b[0][b[1]]))

        same_sel = len(ws) == len(gs) and all(same(a, b)
                                              for a, b in zip(ws, gs))
        rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
        gmax = max(float(g.abs().max()) for g in gw.values())
        gerr = max(float((gg[n] - g).abs().max())
                   / (float(g.abs().max()) + 1e-6 * gmax / SMALL_ZOO_GRAD_TOL)
                   for n, g in gw.items() if n in gg)
        print(f"small ga train: {kind} card vs cpu: {len(want)} terms, worst "
              f"rel err {rel:.2e} (tol 1e-3), assignments and sampled sets "
              f"{len(ws)} {'equal' if same_sel else 'DIFFER'}, {len(gw)} "
              f"gradients of {len(list(cpu.parameters()))} parameters, worst "
              f"err {gerr:.2e} of the tensor's largest "
              f"(tol {SMALL_ZOO_GRAD_TOL:g})")
        if (set(got) != set(want) or not same_sel or len(ws) < 3
                or rel > 1e-3 or set(gg) != set(gw)
                or len(gw) != len(list(cpu.parameters()))
                or gerr > SMALL_ZOO_GRAD_TOL):
            raise AssertionError(f"small ga train {kind} disagrees between "
                                 f"card and cpu")
    _small_ga_ops(device)


# ---------------------------------------------------------------------------
# Data-parallel training across processes: the Runner at world size 1 over
# NCCL, one step on 2 ranks of one card over gloo against the same step in
# one process, the train tool on 2 ranks through dist_train.sh; and the
# native host library
# ---------------------------------------------------------------------------

DIST_TIMEOUT = 600  # s a rank process (or the launcher) may take
DIST_STEPS = 2  # "dist world 1": the Runner's steps, with and without NCCL
DIST_LR = 0.005  # "dist step": a constant learning rate
# "dist step": the in-process batch and the ranks' all-reduced gradients
# agree within these (f32 sums in other orders; the CPU test measured 1.7e-7
# of a tensor's largest gradient, 7.4e-8 of its largest parameter)
DIST_TERM_TOL = 1e-5  # relative, each loss term
DIST_GRAD_TOL = (1e-5, 1e-7)  # of the tensor's largest, of the largest of all
DIST_PARAM_TOL = 1e-6  # of the tensor's largest
DIST_TRAIN_CONFIG = """
_base_ = r"{base}"
data = dict(val=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
                     ref_prefix=r"{val_img}", nframes_span_test={frames}))
evaluation = dict(interval=1)
checkpoint_config = dict(interval=4)
log_config = dict(interval=1)
total_epochs = 2
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(cmd, env=None):
    """A process in a session of its own (so _finish can stop its whole
    group), from the repo root, its output to a temporary file."""
    out = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=env, stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True)
    proc.out = out
    return proc


def _finish(procs, what):
    """Wait for every process, DIST_TIMEOUT s at most; as soon as one fails
    (its peers would wait in a collective) or the time is up, kill every
    process group and raise with each one's output's tail. Returns the
    outputs."""
    import signal

    deadline = time.time() + DIST_TIMEOUT
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"process {bad[0]} exited with {procs[bad[0]].returncode}"
            elif time.time() > deadline:
                failed = f"a process ran over {DIST_TIMEOUT}s"
            else:
                time.sleep(0.2)
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if failed is None and bad:
            failed = f"process {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for p in procs:
        p.out.seek(0)
        outs.append(p.out.read().decode(errors="replace"))
        p.out.close()
    if failed:
        tails = "\n".join(f"--- process {i} (rc {p.returncode}):\n"
                          f"{outs[i][-2500:]}" for i, p in enumerate(procs))
        raise RuntimeError(f"{what}: {failed}\n{tails}")
    return outs


def phase_dist_world1(smi, det, loader, device="cuda", backend="nccl"):
    """The train phase's Runner for DIST_STEPS steps twice from the same
    weights, batches and generator: without a process group, then at world
    size 1 through ``vps_torch.train.dist.init_dist`` over ``backend``
    (NCCL on the card: the broadcast, the gradients' and log vars'
    all-reduces, rank 0's checkpoint). An all-reduce over one rank is a
    copy and the division by 1 exact: the parameters and the logged terms
    must be equal bit for bit. Returns the launch counts of the NCCL run."""
    import torch
    from vps_torch.train import dist
    from vps_torch.train.runner import Runner

    on_card = torch.device(device).type == "cuda"
    w0 = {k: v.detach().clone() for k, v in det.state_dict().items()}
    steps = copy.copy(loader)
    steps.steps = DIST_STEPS
    runs = {}
    for label in ("plain", backend):
        det.load_state_dict(w0)
        if label != "plain":
            dist.init_dist(backend, f"localhost:{_free_port()}", 1, 0)
        try:
            with tempfile.TemporaryDirectory(dir=WORK_DIR) as work:
                runner = Runner(det, steps, {}, work, total_epochs=1,
                                log_interval=1, ckpt_interval=1, seed=SEED)
                _reset_counts()
                state = runner.run()
                _sync(device)
                launches = _counts()
                ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pth"))
            world = dist.get_world_size()
        finally:
            dist.destroy_dist()
        runs[label] = dict(
            params={n: p.detach().clone() for n, p in det.named_parameters()},
            hist=runner.log_history, launches=launches, ckpts=ckpts,
            applied=state.optimizer.count, world=world)
    det.load_state_dict(w0)
    a, b = runs["plain"], runs[backend]
    differ = [n for n in a["params"] if not torch.equal(a["params"][n],
                                                         b["params"][n])]
    terms = [(i, k) for i, (x, y) in enumerate(zip(a["hist"], b["hist"]))
             for k in x if k != "time" and x[k] != y.get(k)]
    print(f"dist world 1: the train phase's Runner, {DIST_STEPS} steps from "
          f"the same weights, batches and generator, without a process group "
          f"and at world size {b['world']} over {backend} (broadcast, "
          f"all-reduced gradients and log vars, rank-0 checkpoint): "
          f"parameters {len(a['params']) - len(differ)} of "
          f"{len(a['params'])} bitwise equal, logged terms "
          f"{'all' if not terms else 'not all'} equal; s/step of step "
          f"{DIST_STEPS} {a['hist'][-1]['time']:.4f} without, "
          f"{b['hist'][-1]['time']:.4f} over {backend} (first steps "
          f"{a['hist'][0]['time']:.3f}, {b['hist'][0]['time']:.3f}); "
          f"checkpoints {a['ckpts']}, {b['ckpts']}; launches {b['launches']}; "
          f"card: {smi}")
    if differ or terms:
        raise AssertionError(f"dist world 1: differs from the plain Runner in "
                             f"{differ[:5]} {terms[:5]}")
    if b["world"] != 1 or a["applied"] != DIST_STEPS \
            or b["applied"] != DIST_STEPS:
        raise AssertionError(f"dist world 1: world {b['world']}, steps "
                             f"applied {a['applied']}, {b['applied']}")
    want_ckpt = [f"ckpt_{DIST_STEPS}.pth"]
    if a["ckpts"] != want_ckpt or b["ckpts"] != want_ckpt:
        raise AssertionError(f"dist world 1: checkpoints {a['ckpts']}, "
                             f"{b['ckpts']}")
    want = _want(corr_f32=2 * DIST_STEPS, corr_backward=DIST_STEPS)
    if on_card and (a["launches"] != want or b["launches"] != want):
        raise AssertionError(f"dist world 1: kernel launches {a['launches']}, "
                             f"{b['launches']}, want {want}")
    return b["launches"]


def _dist_det(device, h, w, depth):
    """The train phase's detector (R-``depth`` FuseTrack, f32,
    fusetrack_train_cfg, seeded weights)."""
    from vps_torch import zoo
    from vps_torch.models.detectors import PanopticFuseTrack, random_init_

    cfg = zoo.f32_compute_overrides(zoo.fusetrack_model_cfg(depth))
    cfg.pop("type")
    return random_init_(PanopticFuseTrack(
        train_cfg=zoo.fusetrack_train_cfg(), test_cfg=zoo.fusetrack_test_cfg(),
        device=device, **cfg), seed=SEED)


def _dist_batch(indices, device, h, w):
    """The global batch's samples ``indices`` (sample i: synth_sample's seed
    SEED + 4 + i) as one batch on ``device``."""
    import torch
    from vps_torch.train.step import IMAGE_KEYS

    samples = [synth_sample(np.random.RandomState(SEED + 4 + i), h, w, MAX_GT)
               for i in indices]
    return {k: torch.as_tensor(np.concatenate([s[k] for s in samples])
                               if k in IMAGE_KEYS
                               else np.stack([s[k] for s in samples]),
                               device=device) for k in samples[0]}


def _dist_one_step(det, batch, device):
    """One ``make_train_step`` step of ``det`` on ``batch`` under
    train_policy (constant lr DIST_LR, the step generator seeded SEED).
    Returns (log vars, the gradients the optimizer got, the step's seconds,
    the all-reduce's seconds): host clock, each ending in a synchronize."""
    import torch
    from vps_torch.train import dist
    from vps_torch.train.optim import build_optimizer
    from vps_torch.train.step import TrainState, make_train_step
    from vps_torch.utils.numerics import train_policy

    opt = build_optimizer(det, lambda step: np.float32(DIST_LR))[0]
    grads, reduce_s = {}, []
    real_step, real_reduce = opt.step, dist.all_reduce_grads

    def step():
        grads.update({n: p.grad.detach().clone() if p.grad is not None
                      else torch.zeros_like(p)
                      for n, p in zip(opt.names, opt.params)})
        return real_step()

    def reduce(params):
        _sync(device)
        t = time.perf_counter()
        real_reduce(params)
        _sync(device)
        reduce_s.append(time.perf_counter() - t)

    opt.step = step
    dist.all_reduce_grads = reduce
    try:
        gen = torch.Generator(device=device).manual_seed(SEED)
        with train_policy():
            _sync(device)
            t = time.perf_counter()
            _, log_vars = make_train_step(det, opt)(TrainState(opt, 0), batch,
                                                    gen)
            _sync(device)
            step_s = time.perf_counter() - t
    finally:
        dist.all_reduce_grads = real_reduce
    if opt.count != 1:
        raise AssertionError(f"dist step: {opt.total_notfinite} steps skipped")
    return ({k: float(v) for k, v in log_vars.items()}, grads, step_s,
            sum(reduce_s))


def _digest(module):
    """A SHA-256 of every parameter's bytes."""
    import hashlib

    digest = hashlib.sha256()
    for _, p in module.named_parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _dist_step_rank(rank, world, port, out, device, h, w, depth, threads):
    """One rank of "dist step" (its own process): join the gloo group,
    build the detector (rank 0's weights reach the others by the
    broadcast), one step on the global batch's sample ``rank``, then one
    more for its warm time; writes ``out/rank<rank>.json`` (log vars,
    launches and a digest of every parameter after the first step; peak
    memory, seconds, the digest after the second) and, rank 0,
    ``out/rank0.pt`` (the first step's gradients the optimizer got and the
    parameters after it). ``threads``:
    the parent's intra-op threads (on the CPU the sums of a conv depend on
    their number)."""
    import torch
    from vps_torch.train import dist
    from vps_torch.utils.numerics import deterministic_cublas, f32_policy

    torch.set_num_threads(threads)
    f32_policy()
    deterministic_cublas()
    dist.init_dist("gloo", f"localhost:{port}", world, rank)
    try:
        dev = dist.rank_device(device, rank)
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.set_device(dev)
        det = _dist_det(dev, h, w, depth)
        dist.broadcast_module(det)
        batch = _dist_batch([rank], dev, h, w)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        log_vars, grads, step_s, reduce_s = _dist_one_step(det, batch, dev)
        launches = _counts()
        rec = dict(log_vars=log_vars, launches=launches, step_s=step_s,
                   reduce_s=reduce_s, digest=_digest(det),
                   reduced_mb=sum(g.numel() * g.element_size()
                                  for g in grads.values()) / 2**20)
        if rank == 0:
            torch.save({"grads": {n: g.cpu() for n, g in grads.items()},
                        "params": {n: p.detach().cpu()
                                   for n, p in det.named_parameters()}},
                       os.path.join(out, "rank0.pt"))
        del grads
        # one more step, warm and started together (rank 0 saved its file
        # meanwhile), for its time and the all-reduce's share
        torch.distributed.barrier()
        _, _, rec["warm_s"], rec["warm_reduce_s"] = _dist_one_step(det, batch,
                                                                   dev)
        rec["warm_digest"] = _digest(det)
        rec["peak"] = torch.cuda.max_memory_allocated() if on_card else 0
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_dist()
    return 0


def phase_dist_step(smi, device="cuda", h=TRAIN_H, w=TRAIN_W, depth=50):
    """One train step at full width on a global batch of 2 (the train
    phase's detector; samples synth_sample seeds SEED + 4 and SEED + 5):
    first in this process on the batch of 2, then on 2 ranks of their own
    processes, both on ``device`` (cuda: card 0, which NCCL refuses to
    share, so over gloo), one sample each. Fails unless the loss terms
    (averaged over the ranks), the all-reduced gradients and the
    parameters after the step agree with the one process's within
    DIST_TERM_TOL, DIST_GRAD_TOL and DIST_PARAM_TOL, and the two ranks'
    parameters, gradients and terms are equal bit for bit. Returns the
    launch counts, summed over the ranks."""
    import torch

    on_card = torch.device(device).type == "cuda"
    det = _dist_det(device, h, w, depth)
    batch = _dist_batch([0, 1], device, h, w)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    want_logs, want_grads, one_s, _ = _dist_one_step(det, batch, device)
    want_grads = {n: g.cpu() for n, g in want_grads.items()}
    want_params = {n: p.detach().cpu().clone()
                   for n, p in det.named_parameters()}
    one_peak = torch.cuda.max_memory_allocated() if on_card else 0
    del det, batch
    if on_card:
        torch.cuda.empty_cache()

    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as out:
        port = _free_port()
        # both ranks on card 0 (the machine has one card), or the CPU
        rank_dev = "cuda:0" if on_card else "cpu"
        code = ("import sys, chip_smoke; sys.exit(chip_smoke._dist_step_rank("
                f"{{r}}, 2, {port}, {out!r}, {rank_dev!r}, {h}, {w}, {depth}, "
                f"{torch.get_num_threads()}))")
        t0 = time.perf_counter()
        _finish([_start([sys.executable, "-c", code.format(r=r)])
                 for r in range(2)], "dist step")
        ranks_s = time.perf_counter() - t0
        recs = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        got = torch.load(os.path.join(out, "rank0.pt"))
    term_err = max(abs(recs[0]["log_vars"][k] - v) / max(abs(v), 1e-6)
                   for k, v in want_logs.items())
    gmax = max(g.abs().max().item() for g in want_grads.values())
    grad_err = max((got["grads"][n] - g).abs().max().item()
                   / (DIST_GRAD_TOL[0] * g.abs().max().item()
                      + DIST_GRAD_TOL[1] * gmax)
                   for n, g in want_grads.items())
    param_err = max((got["params"][n] - p).abs().max().item()
                    / max(p.abs().max().item(), 1e-30)
                    for n, p in want_params.items())
    rel_grad = max((got["grads"][n] - g).abs().max().item()
                   / max(g.abs().max().item(), 1e-30)
                   for n, g in want_grads.items())
    same = (recs[0]["digest"] == recs[1]["digest"]
            and recs[0]["warm_digest"] == recs[1]["warm_digest"])
    for r, rec in enumerate(recs):
        print(f"dist step: rank {r} of 2 on {device} (gloo): one step of 1 "
              f"sample {h}x{w} in {rec['step_s']:.4f}s cold, "
              f"{rec['warm_s']:.4f}s warm; the gradients' all-reduce "
              f"({rec['reduced_mb']:.0f} MiB) {rec['reduce_s']:.4f}s cold, "
              f"{rec['warm_reduce_s']:.4f}s warm "
              f"({rec['warm_reduce_s'] / rec['warm_s']:.3f} of the warm "
              f"step); peak mem {rec['peak'] / 2**30:.2f} GiB, launches of "
              f"the first step {rec['launches']}; card: {smi}")
    print(f"dist step: R-{depth} f32 {h}x{w}, global batch 2: in one process "
          f"{one_s:.4f}s, peak mem "
          f"{one_peak / 2**30:.2f} GiB; 2 ranks "
          f"{ranks_s:.1f}s wall with their start; largest differences: loss "
          f"terms {term_err:.3g} relative (bar {DIST_TERM_TOL}), gradients "
          f"{rel_grad:.3g} of the tensor's largest ({grad_err:.3g} of the "
          f"bar {DIST_GRAD_TOL}), parameters {param_err:.3g} of the tensor's "
          f"largest (bar {DIST_PARAM_TOL}); the two ranks' parameters "
          f"after each step {'bitwise equal' if same else 'differ'}, loss "
          f"{want_logs['loss']:.4f}")
    if not same or recs[0]["log_vars"] != recs[1]["log_vars"]:
        raise AssertionError("dist step: the two ranks differ")
    if set(recs[0]["log_vars"]) != set(want_logs) or set(got["grads"]) \
            != set(want_grads):
        raise AssertionError("dist step: other terms or parameters")
    if term_err > DIST_TERM_TOL or grad_err > 1.0 \
            or param_err > DIST_PARAM_TOL:
        raise AssertionError("dist step: the ranks and the one process differ")
    launches = {k: sum(rec["launches"][k] for rec in recs) for k in KERNELS}
    want = _want(corr_f32=4, corr_backward=2)
    if on_card and launches != want:
        raise AssertionError(f"dist step: kernel launches {launches} != {want}")
    return launches


def phase_dist_train(smi, fx, device="cuda"):
    """The train tool on 2 ranks through ``vps_torch/tools/dist_train.sh``
    (NPROC=2; on the card both on card 0 over gloo), on the dataset phase's
    fixture and config: 2 epochs of 1 step (one train video of 2 frames,
    one sample a rank), the validation hook after each over the val videos
    (video v on rank v % 2; merged on rank 0), rank 0's checkpoint. Fails
    unless both ranks exit 0, the work dir holds one checkpoint, the log
    says hosts=2 and holds each epoch's step and eval once (rank 1 logs
    nothing below ERROR), and each epoch's merge holds every val frame
    once. Returns the launch counts, summed over the ranks."""
    import torch

    on_card = torch.device(device).type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(fx["tmp"], "dist_train")
    os.makedirs(tmp)
    cfg_path = os.path.join(tmp, "cfg.py")
    with open(cfg_path, "w") as f:
        f.write(DIST_TRAIN_CONFIG.format(base=fx["cfg"], val_ann=fx["val_ann"],
                                         val_img=fx["val_img"],
                                         frames=fx["val_frames"]))
        if fx["tiny"]:
            f.write(f'data["val"]["pipeline"] = dict(img_scale=({fx["w"]}, '
                    f'{fx["h"]}))\n')
    work, counts = os.path.join(tmp, "work"), os.path.join(tmp, "counts")
    env = dict(os.environ, NPROC="2", PORT=str(_free_port()),
               PYTHON=sys.executable)
    cmd = ["bash", os.path.join(repo, "vps_torch", "tools", "dist_train.sh"),
           cfg_path, "--work_dir", work, "--launch-counts", counts]
    cmd += (["--device", "cuda:0", "--dist-backend", "gloo"] if on_card
            else ["--device", "cpu"])
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _finish([_start(cmd, env)], "dist train")
    wall = time.perf_counter() - t0

    epochs = 2
    n_val = fx["val_videos"] * fx["val_frames"]
    ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pth"))
    with open(os.path.join(work, "train.log")) as f:
        log = f.read()
    steps = [float(m) for m in re.findall(r"Epoch \[\d+\]\[1\] time: ([0-9.]+)s",
                                          log)]
    evals = re.findall(r"Eval \[\d+\] .*eval_frames: ([0-9.]+)", log)
    parts = {}
    for e in range(1, epochs + 1):
        for r in range(2):
            with open(os.path.join(work, ".eval_hook",
                                   f"epoch{e}.host{r}.pkl"), "rb") as f:
                parts[e, r] = set(pickle.load(f))
    launches = []
    for r in range(2):
        with open(os.path.join(counts, f"launches.rank{r}.json")) as f:
            launches.append(json.load(f))
    print(f"dist train: vps_torch/tools/dist_train.sh NPROC=2 on "
          f"{'card 0 (gloo)' if on_card else 'the cpu (gloo)'}, "
          f"{'tiny' if fx['tiny'] else 'R-50'} f32 {fx['h']}x{fx['w']}, "
          f"{epochs} epochs of 1 step (batch 1 a rank), the eval hook over "
          f"{n_val} val frames each epoch: {wall:.1f}s wall with the ranks' "
          f"start; s/step {', '.join(f'{t:.4f}' for t in steps)} (rank 0's "
          f"log; every rank steps in lockstep); checkpoints {ckpts}; merged "
          f"evals of {evals} frames, per rank "
          f"{[len(parts[1, r]) for r in range(2)]}; launches by rank "
          f"{launches}; card: {smi}")
    if ckpts != [f"ckpt_{epochs}.pth"]:
        raise AssertionError(f"dist train: checkpoints {ckpts}")
    if log.count("devices=2 hosts=2 batch/host=1 steps/epoch=1") != 1:
        raise AssertionError("dist train: the log's set-up line is not there "
                             "once with hosts=2")
    if len(steps) != epochs or len(evals) != epochs \
            or any(float(n) != n_val for n in evals):
        raise AssertionError(f"dist train: logged steps {steps}, evals {evals}"
                             f" (rank 1 must log nothing below ERROR)")
    for e in range(1, epochs + 1):
        a, b = parts[e, 0], parts[e, 1]
        if a & b or len(a | b) != n_val:
            raise AssertionError(f"dist train: epoch {e}'s merge holds "
                                 f"{len(a)} + {len(b)} frames, "
                                 f"{len(a & b)} twice")
    # per rank: 2 steps (2 correlations and 1 backward each) and its val
    # video, 2 f32 correlations a frame, each epoch
    per_rank = _want(corr_f32=2 * epochs + 2 * epochs * fx["val_frames"],
                     corr_backward=epochs)
    if on_card and any(c != per_rank for c in launches):
        raise AssertionError(f"dist train: kernel launches {launches}, want "
                             f"{per_rank} a rank")
    return {"dist train": {k: sum(c.get(k, 0) for c in launches)
                           for k in KERNELS}}


def phase_native(smi):
    """The native host library (``vps_torch.native``, built with g++ here)
    against its numpy versions on seeded masks and boxes: the RLE codec on
    a 1024x2048 mask and edge cases, greedy NMS and Soft-NMS (hard,
    linear, gaussian) over 1000 boxes, the IoU matrix of 1000 x 1000; host
    ms of each beside its numpy version's. Fails on any difference (the
    gaussian Soft-NMS's scores: within 1e-6, numpy's exp and libm's differ
    by an ulp). The detection evaluation's IoU and the COCO masks' RLE go
    through the library (``eval.mean_ap``, ``data.coco``)."""
    from vps_torch import native
    from vps_torch.data import coco
    from vps_torch.eval import mean_ap

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 9)

    def ms(fn, *args, reps=3):
        t = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return out, (time.perf_counter() - t) / reps * 1e3

    pairs = {}  # name: (native ms, numpy ms)

    def both(name, fn, fn_np, *args, reps=3):
        out, t = ms(fn, *args, reps=reps)
        out_np, t_np = ms(fn_np, *args, reps=reps)
        pairs[name] = (t, t_np)
        return out, out_np

    masks = [np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8),
             np.eye(1, 35, 0, np.uint8).reshape(5, 7), np.ones((1, 1), np.uint8)]
    ys, xs = np.mgrid[0:1024, 0:2048]
    big = ((((xs - 900) / 300.0) ** 2 + ((ys - 500) / 200.0) ** 2 <= 1)
           | (rng.rand(1024, 2048) > 0.999)).astype(np.uint8)
    for m in masks + [big]:  # the last one's times are kept
        s, s_np = both("rle_encode", native.rle_encode, native.rle_encode_np, m)
        d, d_np = both("rle_decode", native.rle_decode, native.rle_decode_np,
                       s, *m.shape)
        if s != s_np or not (np.array_equal(d, m) and np.array_equal(d_np, m)):
            raise AssertionError(f"native: RLE of a {m.shape} mask differs")
    c = rng.rand(1000, 2) * [2048, 1024]
    wh = 8 + rng.rand(1000, 2) * 200
    dets = np.concatenate([c - wh / 2, c + wh / 2,
                           rng.randint(1, 50, (1000, 1)) / 50.0],
                          1).astype(np.float32)
    ious, ious_np = both("bbox_overlaps", native.bbox_overlaps,
                         native.bbox_overlaps_np, dets, dets)
    keep, keep_np = both("cpu_nms", native.cpu_nms, native.cpu_nms_np, dets,
                         0.5)
    if not np.array_equal(ious, ious_np) or not np.array_equal(keep, keep_np):
        raise AssertionError("native: IoU or NMS differs from numpy")
    soft_err = 0.0
    for method in ("hard", "linear", "gaussian"):
        (r, k), (r_np, k_np) = both(
            f"soft_nms {method}", native.cpu_soft_nms, native.cpu_soft_nms_np,
            dets, 0.3, 0.5, 1e-3, method, reps=1)
        err = float(np.abs(r - r_np).max()) if len(r) else 0.0
        soft_err = max(soft_err, err)
        if not np.array_equal(k, k_np) or err > (1e-6 if method == "gaussian"
                                                 else 0.0):
            raise AssertionError(f"native: soft-NMS {method} differs by {err}")
    if mean_ap.bbox_overlaps is not native.bbox_overlaps \
            or coco.rle_decode is not native.rle_decode:
        raise AssertionError("native: the evaluation does not call the library")
    print(f"native: g++ build and load {build_s:.2f}s; equal to numpy (the "
          f"gaussian soft-NMS's scores within {soft_err:.3g}); kept "
          f"{len(keep)} of 1000 by NMS; host ms, native / numpy: "
          + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in pairs.items())
          + f" (RLE: a 1024x2048 mask); host of: {smi}")


def _timed(name, fn, *args, **kw):
    """fn(*args, **kw), then a line of its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f}s wall")
    return out


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
    smi = _timed("build", phase_build)
    kernels = _timed("kernels correlation", phase_kernels_correlation) + [
        _timed("kernels correlation backward",
               phase_kernels_correlation_backward),
        _timed("kernels windowed", phase_kernels_windowed)]
    later = {}
    paths = {"main": _timed("main", phase_main, smi),
             "window": _timed("window", phase_main, smi, dcn_window=WINDOW),
             "train": _timed("train", phase_train, smi, then=lambda det, ld:
                             later.update({"dist world 1": _timed(
                                 "dist world 1", phase_dist_world1, smi, det,
                                 ld)})),
             "fuse": _timed("fuse", phase_detector, smi, "PanopticFuse"),
             "track": _timed("track", phase_detector, smi, "PanopticTrack"),
             "aug": _timed("aug", phase_aug, smi),
             "ohem train": _timed("ohem train", phase_train, smi,
                                  steps=OHEM_STEPS, sampler=OHEM),
             "dist step": _timed("dist step", phase_dist_step, smi)}
    paths.update(later)
    _timed("small", phase_small)
    _timed("small window", phase_small, dcn_window=WINDOW)
    _timed("small fuse", phase_small, kind="PanopticFuse")
    _timed("small track", phase_small, kind="PanopticTrack")
    _timed("small att", phase_small, refine_type="att")
    _timed("small aug", phase_small_aug)
    _timed("small train", phase_small_train)
    _timed("small ohem train", phase_small_train, sampler=dict(OHEM, num=32))
    paths.update(_timed("zoo", phase_zoo, smi,
                        ("mask_rcnn", "cascade_mask_rcnn", "htc")))
    paths.update({f"zoo {k}": v for k, v in _timed(
        "zoo others", phase_zoo, smi, ZOO_OTHERS,
        images=ZOO_OTHERS_IMAGES).items()})
    _timed("small zoo", phase_small_zoo)
    paths.update(_timed("zoo train", phase_zoo_train, smi,
                        ZOO_TRAIN_LONG + ZOO_TRAIN_OTHERS))
    _timed("small zoo train", phase_small_zoo_train)
    _timed("train repeatable", phase_train_repeatable, smi)
    paths.update(_timed("single stage", phase_single_stage, smi))
    _timed("small single stage", phase_small_single_stage)
    paths.update(_timed("single stage train", phase_single_stage_train, smi))
    _timed("small single stage train", phase_small_single_stage_train)
    paths.update(_timed("backbones", phase_backbones, smi))
    _timed("small backbones", phase_small_zoo, cfgs=_tiny_backbone_cfgs(),
           label="small backbones")
    _timed("small backbone ops", phase_small_backbone_ops)
    paths.update(_timed("backbones train", phase_backbones_train, smi))
    _timed("small backbones train", phase_small_zoo_train,
           cfgs=_tiny_backbone_cfgs(), label="small backbones train")
    paths.update(_timed("ga", phase_ga, smi))
    _timed("small ga", phase_small_ga)
    paths.update(_timed("ga train", phase_ga_train, smi))
    _timed("small ga train", phase_small_ga_train)
    paths.update(_timed(
        "dataset (robustness, detection eval and dist train included)",
        phase_dataset,
        smi, numerics, then=(lambda fx: phase_robustness(smi, fx),
                             lambda fx: phase_detection_eval(smi, fx),
                             lambda fx: _timed("dist train", phase_dist_train,
                                               smi, fx))))
    _timed("native", phase_native, smi)
    paths.update(_timed("viper", phase_viper, smi))
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
