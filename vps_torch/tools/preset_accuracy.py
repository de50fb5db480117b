"""Preset accuracy (the port's counterpart of the repo's
``tools/preset_accuracy.py``, flag for flag): train the tiny FuseTrack on
the synthetic VPS fixture, then score every inference preset with the
port's own VPQ chain.

With no released checkpoints, fixture VPQ is the accuracy gate of every
preset that changes the numbers: a preset is worth its speed only if its
VPQ holds. The chain runs through the port's entry points as processes of
their own, nothing mocked: ``vps_torch.tools.train`` (f32 compute, the
trainer's default) -> ``vps_torch.tools.test_vpq --preset P`` for each
preset -> ``vps_torch.tools.eval_vpq``. The fixture comes from
``vps_torch.data.synth``, the eval GT from the repo's ``prepare_data``
scripts, run as processes too.

    python -m vps_torch.tools.preset_accuracy --work_dir D [--epochs 40]
        [--lr 0.002] [--train_videos 10] [--val_videos 2] [--frames 4]
        [--size 256x128] [--seed 0]
        [--presets exact,half-flow,lowres-sem,fast,fast-lowres]
        [--skip_train] [--device cuda|cpu]

``--device`` goes to train and test_vpq (the card unless ``cpu``); eval_vpq
is host code and runs with no card visible, as the JAX tool runs it on the
CPU. The presets' test_vpq -> eval_vpq chains run side by side, one a
preset (each child's output does not depend on it; the host threads are
split between them unless ``OMP_NUM_THREADS`` is set). A child that fails
fails the tool, with the end of its output; no preset is skipped. Writes
``D/preset_accuracy.json`` and prints a markdown table. ``main(argv)``
returns the json's dict, with each child's wall seconds under
``children`` (not written to the file).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

CONFIG_TMPL = """
_base_ = r"{base}"
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()

_pipe = dict(img_scale=({W}, {H}), ratio_range=(1.0, 1.0), flip_ratio=0.5,
             crop_size=({H}, {W}), max_gt=8)
data = dict(
    imgs_per_gpu=1,
    workers_per_gpu=0,
    train=dict(times=1, dataset=dict(
        ann_file=r"{train_ann}", img_prefix=r"{train_img}",
        ref_prefix=r"{train_img}", seg_prefix=r"{train_seg}",
        ref_ann_file=r"{train_ann}", offsets=[-1, 1], pipeline=_pipe)),
    test=dict(ann_file=r"{val_ann}", img_prefix=r"{val_img}",
              ref_prefix=r"{val_img}", nframes_span_test={frames},
              test_mode=True, pipeline=dict(img_scale=({W}, {H}))),
)
optimizer = dict(type="SGD", lr={lr}, momentum=0.9, weight_decay=0.0001)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup="linear", warmup_iters=50,
                 warmup_ratio=0.333, step=[{step_epoch}])
checkpoint_config = dict(interval={epochs})
log_config = dict(interval=10)
total_epochs = {epochs}
work_dir = r"{work}"
"""


def run(cmd, env, timeout, tag, seconds):
    """``cmd`` from the repo's root; its output on failure, then raises.
    Appends (tag, wall seconds) to ``seconds``."""
    print(f"[preset_accuracy] {tag}: {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    seconds.append((tag, time.perf_counter() - t0))
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise RuntimeError(f"{tag} failed (rc={r.returncode})")
    return r


def epoch_losses(log_path):
    """Per-epoch mean total loss from train.log lines
    'Epoch [e][i] ... loss: X'."""
    by_epoch = {}
    pat = re.compile(r"Epoch \[(\d+)\].*?[, ]loss: ([0-9.eE+-]+)")
    with open(log_path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                by_epoch.setdefault(int(m.group(1)), []).append(
                    float(m.group(2)))
    return {e: sum(v) / len(v) for e, v in sorted(by_epoch.items())}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Fixture VPQ of every preset")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--train_videos", type=int, default=10)
    p.add_argument("--val_videos", type=int, default=2)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--size", default="256x128", help="WxH")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--presets",
                   default="exact,half-flow,lowres-sem,fast,fast-lowres")
    p.add_argument("--skip_train", action="store_true",
                   help="reuse work_dir fixture + checkpoint")
    p.add_argument("--device", default="cuda",
                   help="train and test_vpq's device (eval_vpq: the host)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))
    work = osp.abspath(args.work_dir)
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    host_env = dict(env, CUDA_VISIBLE_DEVICES="")
    py = sys.executable
    seconds = []

    fix = osp.join(work, "fixture")
    cfg_path = osp.join(work, "cfg.py")
    train_work = osp.join(work, "train")
    if not args.skip_train:
        from vps_torch.data.synth import make_synth_vps

        train_ann, train_img, train_seg = make_synth_vps(
            fix, mode="train", n_videos=args.train_videos,
            n_frames=args.frames, H=H, W=W, seed=args.seed,
            first_video=101)
        val_ann, val_img, _ = make_synth_vps(
            fix, mode="val", n_videos=args.val_videos,
            n_frames=args.frames, H=H, W=W, seed=args.seed + 1,
            first_video=1)
        # eval-side GT through the repo's prepare_data scripts
        for script, extra in (("create_panoptic_labels.py",
                               ["--workers", "1"]),
                              ("create_panoptic_video_labels.py", [])):
            run([py, osp.join(REPO, "prepare_data", script), "--mode", "val",
                 "--root_dir", fix] + extra, host_env, 600, script, seconds)
        with open(cfg_path, "w") as f:
            f.write(CONFIG_TMPL.format(
                base=osp.join(REPO, "vps_torch", "configs", "cityscapes",
                              "fusetrack.py"),
                W=W, H=H, frames=args.frames, train_ann=train_ann,
                train_img=train_img, train_seg=train_seg, val_ann=val_ann,
                val_img=val_img, lr=args.lr, epochs=args.epochs,
                step_epoch=max(1, int(args.epochs * 0.75)),
                work=train_work))
        run([py, "-m", "vps_torch.tools.train", cfg_path, "--device",
             args.device], env, 7200, "train", seconds)

    losses = epoch_losses(osp.join(train_work, "train.log"))
    if not losses:
        raise RuntimeError(
            "no 'Epoch [e][i] ... loss:' lines in train.log — steps/epoch "
            "is probably below log_config interval (10); raise "
            "--train_videos/--frames or lower the interval in CONFIG_TMPL")
    tail = list(losses.values())[-5:]
    head = list(losses.values())[:1]
    print(f"[preset_accuracy] loss: first epoch {head[0]:.3f} -> last 5 "
          f"epochs {[f'{v:.3f}' for v in tail]}", flush=True)

    with open(osp.join(train_work, "latest.txt")) as f:
        ckpt = osp.join(train_work, f.read().strip())

    gt_json = osp.join(fix, "panoptic_gt_val_city_vps.json")
    truth_dir = osp.join(fix, "val", "panoptic_video")
    presets = args.presets.split(",")
    # the presets' chains run side by side: host threads split between them
    # unless the caller set a count
    threads = str(max(1, (os.cpu_count() or 1) // len(presets)))
    chain_env = {k: dict(e, OMP_NUM_THREADS=e.get("OMP_NUM_THREADS", threads))
                 for k, e in (("card", env), ("host", host_env))}

    def score(preset):
        out_pkl = osp.join(work, f"out_{preset}.pkl")
        run([py, "-m", "vps_torch.tools.test_vpq", cfg_path, "--checkpoint",
             ckpt, "--out", out_pkl, "--preset", preset, "--chunk",
             str(args.frames), "--lambda", "1", "--labeled_fid", "0",
             "--nframes_per_video", str(args.frames),
             "--pan_im_json_file", gt_json, "--device", args.device],
            chain_env["card"], 3600, f"test_vpq[{preset}]", seconds)
        r = run([py, "-m", "vps_torch.tools.eval_vpq",
                 "--submit_dir", out_pkl.replace(".pkl", "_pans_unified"),
                 "--truth_dir", truth_dir, "--pan_gt_json_file", gt_json,
                 "--nframes_per_video", str(args.frames)],
                chain_env["host"], 1200, f"eval_vpq[{preset}]", seconds)
        line = [l for l in r.stdout.splitlines()
                if l.startswith("vpq_all")][-1]
        print(f"[preset_accuracy] {preset}: {line}", flush=True)
        return line

    with ThreadPoolExecutor(len(presets)) as pool:
        lines = list(pool.map(score, presets))
    table = {}
    for preset, line in zip(presets, lines):
        nums = re.findall(r"([0-9.]+)", line)
        table[preset] = dict(vpq_all=float(nums[0]), vpq_thing=float(nums[1]),
                             vpq_stuff=float(nums[2]))

    result = dict(presets=table, epochs=args.epochs,
                  epoch_losses={str(k): v for k, v in losses.items()},
                  fixture=dict(train_videos=args.train_videos,
                               val_videos=args.val_videos,
                               frames=args.frames, size=f"{W}x{H}"),
                  checkpoint=ckpt)
    with open(osp.join(work, "preset_accuracy.json"), "w") as f:
        json.dump(result, f, indent=1)

    print("\n| preset | fixture VPQ | VPQ-thing | VPQ-stuff |")
    print("|---|---|---|---|")
    for k, v in table.items():
        print(f"| {k} | {v['vpq_all']:.2f} | {v['vpq_thing']:.2f} "
              f"| {v['vpq_stuff']:.2f} |")
    return dict(result, children=seconds)


if __name__ == "__main__":
    main()
