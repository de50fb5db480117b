"""Drive vps_torch on one NVIDIA GPU (H100) and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. build    -- nvcc builds every kernel from vps_torch/csrc (sm_90a), one
                 nvcc per source, all started together; prints the build
                 times and the card (nvidia-smi).
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the shapes its path gives it (and ragged ones), with the
                 tolerance stated; CUDA-event medians beside the bound.
  3. main     -- PanopticFuseTrack at the full R-50 `half-flow` preset with
                 seeded random weights, predict_video over seeded random
                 1024x2048 frames (the first a reset); asserts finite outputs
                 of the contract shapes and the kernel launch counts;
                 prints steady-state frames/s and peak device memory.
     window   -- the same with `panoptic.dcn_window = 4`: the semantic head's
                 12 deformable convs a frame run the windowed kernel.
  4. small    -- the tiny `exact` model on a 64x128 clip on the card against
                 the same model's plain CPU path: equal detections and keep
                 sets, >= 0.999 semantic/panoptic agreement; then the same
                 with `dcn_window = 4`.
Each path is driven with every launch count set to 0 just before it and read
just after. Then a `kernels` JSON line, the nvidia-smi line and, last, the
result line {"ok": true, "device": {...}}. Any failure raises: exit code
!= 0, no result.
TF32 is off for matmuls and convolutions: float32 work runs in full float32,
as the JAX reference computes it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    half-flow main path: the tensor-core kernel; and f32: the SIMT kernel),
    at ragged shapes (C = 30 and 300, staged element by element; C = 512;
    stride2 5 and 6), and at FlowNetC's geometry with W = 100, not a
    multiple of the 64-pixel block. Tolerance: f32 atol 1e-5 + rtol 1e-5
    (summation order); bf16 one output ulp (rtol 2^-7) + atol 1e-6: products
    of bf16 values are exact in f32, so both round an f32 sum, taken in
    another order, to bf16, which can land one ulp apart."""
    import torch
    from vps_torch.ops import correlation, correlation_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sites = {
        "liteflow": ((1, H // 4, W // 4, 256), 4, 1),
        "flownetc": ((1, H // 16, W // 16, 256), 20, 2),
    }
    cases = [(name, shape, md, s2, dt) for name, (shape, md, s2) in sites.items()
             for dt in ("bfloat16", "float32")]
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
    max_err = 0.0
    per_frame = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bounds = []
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
        max_err = max(max_err, float(err.max()))
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
            bounds.append((bound, by))
    return dict(name="correlation", route="cuda",
                source="vps_torch/csrc/correlation.cu",
                replaces="vps_tpu/ops/correlation.py:32",
                max_abs_err=max_err, bound_by=max(bounds)[1],
                library_ms=None, **per_frame)


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
    the offsets x8 (mostly clamped to +-R), and ragged shapes in bf16 and f32
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
    return dict(name="deform_conv_windowed", route="cuda",
                source="vps_torch/csrc/deform_conv_windowed.cu",
                replaces="vps_tpu/ops/deform_conv.py:447",
                max_abs_err=max_err, bound_by=max(bound_by)[1],
                library_ms=None, ms=frame["ms"], plain_ms=frame["plain_ms"],
                bound_ms=frame["bound_ms"])


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


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_main(smi, device="cuda", h=H, w=W, dcn_window=None):
    """The R-50 half-flow path (with ``dcn_window`` set: the windowed
    semantic head). Returns the launch counts of the run."""
    import torch
    from vps_torch import zoo
    from vps_torch.models.detectors import (
        PanopticFuseTrack, empty_track_state, predict_video, random_init_)
    from vps_torch.models.panoptic_fpn import DeformConvWithOffset
    from vps_torch.ops import correlation, deform_conv2d_windowed

    cfg = zoo.preset_overrides(zoo.fusetrack_model_cfg(), "half-flow")
    cfg.pop("type")
    cfg["panoptic"]["dcn_window"] = dcn_window
    tcfg = zoo.fusetrack_test_cfg()
    t0 = time.perf_counter()
    det = random_init_(PanopticFuseTrack(test_cfg=tcfg, device=device, **cfg),
                       seed=SEED)
    _sync(device)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(
        rng.randn(FRAMES, 1, h, w, 3).astype(np.float32)).to(device)
    state = empty_track_state(256, device=device)
    cap_det = tcfg["panoptic"]["max_det"]

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    correlation.launches = 0
    deform_conv2d_windowed.launches = 0
    t0 = time.perf_counter()
    first, carry = predict_video(det, frames[:1], [True], state, frames[0])
    _sync(device)
    t1 = time.perf_counter()
    # the windowed kernel's weight layouts, made in the first frame
    dcns = [m for m in det.modules() if isinstance(m, DeformConvWithOffset)]
    layouts = [getattr(m._cast, "_vps_fused_weight", None) for m in dcns]
    rest, carry = predict_video(det, frames[1:], [False] * (FRAMES - 1),
                                carry[0], carry[2], prev_feats=carry[1])
    _sync(device)
    t2 = time.perf_counter()
    launches = dict(correlation=correlation.launches,
                    deform_conv_windowed=deform_conv2d_windowed.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    out = {k: torch.cat([first[k], rest[k]]) for k in first}
    _check_outputs(out, FRAMES, cap_det, h, w)
    # 2 cost volumes a frame; 3 convs x 4 levels a frame when windowed
    want = dict(correlation=2 * FRAMES,
                deform_conv_windowed=12 * FRAMES if dcn_window else 0)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} over "
                             f"{FRAMES} frames")
    kept = sum(a is not None and getattr(m._cast, "_vps_fused_weight", None) is a
               for m, a in zip(dcns, layouts))
    if on_card and dcn_window and kept != len(dcns):
        raise AssertionError(f"windowed weight layouts rebuilt after frame 0: "
                             f"{len(dcns) - kept} of {len(dcns)}")
    ndet = out["det_valid"].sum(1).tolist()
    nkeep = out["num_keep"].tolist()
    fps = (FRAMES - 1) / (t2 - t1)
    name = "main" if dcn_window is None else "window"
    print(f"{name}: PanopticFuseTrack R-50 half-flow dcn_window={dcn_window} "
          f"{h}x{w} x{FRAMES} frames "
          f"(frame 0 reset), init {init_s:.1f}s, first frame {t1 - t0:.3f}s, "
          f"steady {fps:.3f} frames/s over {FRAMES - 1} frames, "
          f"peak mem {peak / 2**30:.2f} GiB, launches {launches} "
          f"over {FRAMES} frames, "
          + (f"DCN weight layouts kept from frame 0 {kept}/{len(dcns)}, "
             if dcn_window else "")
          + f"dets/frame {ndet}, kept/frame {nkeep}, "
          f"TF32 off; card: {smi}")
    return launches


def phase_small(device="cuda", dcn_window=None):
    """Port on the card vs the port's plain CPU path, same weights, tiny
    exact-preset model (R-18, TinyFlow) on a 3-frame 64x128 clip (with
    ``dcn_window``: the windowed kernel on the card, its plain version on
    the CPU)."""
    import torch
    from vps_torch import zoo
    from vps_torch.models.detectors import (
        PanopticFuseTrack, empty_track_state, predict_video, random_init_)
    from vps_torch.ops import deform_conv2d_windowed

    cfg = zoo.exact_overrides(zoo.tiny_overrides(zoo.fusetrack_model_cfg()))
    cfg.pop("type")
    cfg["panoptic"]["dcn_window"] = dcn_window
    tcfg = zoo.fusetrack_test_cfg()
    tcfg["rpn"].update(nms_pre=128, max_num=64)
    tcfg["panoptic"].update(score_thresh=0.2, max_det=12)
    cpu = random_init_(PanopticFuseTrack(test_cfg=tcfg, device="cpu", **cfg), 1)
    # a milder classifier than random_init_'s: probabilities that saturate to
    # 1.0 in f32 tie, and ulp-level differences between the two devices then
    # reorder the detections
    with torch.no_grad():
        cpu.bbox_head.fc_cls.weight.mul_(0.25)
        cpu.bbox_head.fc_cls.bias.mul_(0.25)
    gpu = PanopticFuseTrack(test_cfg=tcfg, device=device, **cfg)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.RandomState(SEED + 1)
    clip = torch.from_numpy(rng.randn(3, 1, 64, 128, 3).astype(np.float32))
    resets = [True, False, False]
    want, _ = predict_video(cpu, clip, resets, empty_track_state(64, device="cpu"),
                            clip[0])
    deform_conv2d_windowed.launches = 0
    got, _ = predict_video(gpu, clip.to(device), resets,
                           empty_track_state(64, device=device),
                           clip[0].to(device))
    got = {k: v.cpu() for k, v in got.items()}
    if dcn_window and torch.device(device).type == "cuda" and \
            deform_conv2d_windowed.launches != 12 * len(resets):
        raise AssertionError(f"small clip: {deform_conv2d_windowed.launches} "
                             f"windowed launches, want 12 a frame")
    for k in ("det_valid", "det_labels", "num_keep", "panoptic_valid",
              "panoptic_cls_inds", "panoptic_det_obj_ids"):
        if not torch.equal(got[k].long(), want[k].long()):
            raise AssertionError(f"small clip: {k} differs on the card")
    box_diff = (got["det_bboxes"] - want["det_bboxes"]).abs()
    box_err = float(box_diff.max())
    sseg = float((got["fcn_outputs"] == want["fcn_outputs"]).float().mean())
    pan = float((got["panoptic_outputs"] == want["panoptic_outputs"]).float().mean())
    ndet = int(want["det_valid"].sum())
    print(f"small: tiny exact dcn_window={dcn_window} 64x128 x3 card vs cpu: "
          f"dets {ndet} equal, "
          f"box max err {box_err:.2e} (tol 2e-2), semantic agree {sseg:.5f}, "
          f"panoptic agree {pan:.5f} (tol 0.999)")
    if ndet == 0 or box_err > 2e-2 or sseg < 0.999 or pan < 0.999:
        worst = np.unravel_index(int(box_diff.argmax()), tuple(box_diff.shape))
        print(f"small: worst box {worst}: card {got['det_bboxes'][worst[:2]]} "
              f"cpu {want['det_bboxes'][worst[:2]]} probs card "
              f"{got['det_probs'][worst[:2]]} cpu {want['det_probs'][worst[:2]]}")
        raise AssertionError("small clip disagrees between card and cpu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import vps_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_build()
    kernels = [phase_kernels_correlation(), phase_kernels_windowed()]
    main_launches = phase_main(smi)
    window_launches = phase_main(smi, dcn_window=WINDOW)
    kernels[0]["launches"] = main_launches["correlation"]
    kernels[1]["launches"] = window_launches["deform_conv_windowed"]
    phase_small()
    phase_small(dcn_window=WINDOW)
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
