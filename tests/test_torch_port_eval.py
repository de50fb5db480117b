"""Port parity, VPQ and the unified panoptic artifacts: vps_torch.eval
against vps_tpu.eval on seeded numpy panoptic maps, exactly, in numbers and
in the files written."""

import filecmp
from pathlib import Path

import numpy as np

from vps_tpu.eval.unified import (
    encode_panoptic_video as j_encode_panoptic_video,
    get_unified_pan_result as j_get_unified_pan_result,
    save_panoptic_outputs as j_save_panoptic_outputs,
)
from vps_tpu.eval.vpq import vpq_eval_all as j_vpq_eval_all

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.eval.unified import (
    encode_panoptic_video,
    get_unified_pan_result,
    save_panoptic_outputs,
)
from vps_torch.eval.vpq import vpq_eval_all

H, W, FRAMES, NUM_STUFF = 48, 64, 5, 11
CATEGORIES = {i: dict(id=i, isthing=int(i >= NUM_STUFF),
                      color=[(i * 37 + 29) % 256, (i * 91 + 7) % 256,
                             (i * 173 + 83) % 256]) for i in range(19)}


def _frames(seed):
    """Model outputs of a FRAMES-frame video: semantic maps (stuff bands,
    things in boxes, a little noise), panoptic maps (stuff ids, instance
    slots NUM_STUFF + k, void 255), 1-based thing classes (one of them
    disagreeing with the semantic map) and track ids (one duplicated)."""
    rng = np.random.RandomState(seed)
    segs, pans, clss, oids, names = [], [], [], [], []
    for t in range(FRAMES):
        seg = np.repeat(rng.choice(NUM_STUFF, 4)[:, None], H // 4, 0)
        seg = np.repeat(seg, W, 1).astype(np.uint8)
        pan = seg.copy()
        cls = rng.randint(1, 9, 4)
        for k in range(4):
            y, x = rng.randint(0, H - 12), rng.randint(0, W - 16)
            seg[y:y + 12, x:x + 16] = NUM_STUFF - 1 + cls[k]
            pan[y:y + 12, x:x + 16] = NUM_STUFF + k
        cls[3] = cls[3] % 8 + 1  # the instance's class loses the vote
        noise = rng.rand(H, W) < 0.02
        seg[noise] = rng.randint(0, 19, noise.sum())
        pan[:2] = 255
        segs.append(seg)
        pans.append(pan)
        clss.append(cls)
        oids.append(np.array([0, 1, 2, 1 if t % 2 else 3]))
        names.append(f"{seed:04d}_{t:04d}_city_newImg8bit.png")
    return segs, pans, clss, oids, names


def test_unified_maps_and_artifacts_match_jax(tmp_path):
    args = [sum(parts, []) for parts in zip(*(_frames(s) for s in (1, 2)))]
    kw = dict(names=args[4], stuff_area_limit=64, num_stuff=NUM_STUFF)
    got = get_unified_pan_result(*args[:4], **kw)
    want = j_get_unified_pan_result(*args[:4], **kw)
    assert list(got) == list(want) == args[4]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert any((v[..., 2] > 0).any() for v in want.values())
    for out, fn in ((tmp_path / "torch", save_panoptic_outputs),
                    (tmp_path / "jax", j_save_panoptic_outputs)):
        fn(got, CATEGORIES, str(out), lambda_=1, labeled_fid=0,
           nframes_per_video=FRAMES)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 2 * FRAMES + 1
    for f in files:
        assert filecmp.cmp(tmp_path / "torch" / f, tmp_path / "jax" / f,
                           shallow=False), f


def test_vpq_matches_jax(tmp_path):
    """Two videos of FRAMES frames: the GT from one set of maps, the
    predictions from a perturbed one, through encode_panoptic_video; every
    window size, the printed numbers and the vpq-*.txt files."""
    videos = []
    for seed in (3, 4):
        segs, pans, clss, oids, names = _frames(seed)
        gt = get_unified_pan_result(segs, pans, clss, oids, names=names,
                                    stuff_area_limit=0, num_stuff=NUM_STUFF)
        pred_pans = [p.copy() for p in pans]
        pred_pans[1][pred_pans[1] == NUM_STUFF + 2] = 4  # a missed instance
        pred = get_unified_pan_result(segs, pred_pans, clss, oids,
                                      names=names, stuff_area_limit=64,
                                      num_stuff=NUM_STUFF)
        gt_png, gt_json = encode_panoptic_video([gt[n] for n in names],
                                                CATEGORIES)
        jg_png, jg_json = j_encode_panoptic_video([gt[n] for n in names],
                                                  CATEGORIES)
        for a, b in zip(gt_png, jg_png):
            np.testing.assert_array_equal(a, b)
        assert gt_json == jg_json
        pr_png, pr_json = encode_panoptic_video([pred[n] for n in names],
                                                CATEGORIES)
        videos.append(list(zip(gt_json, pr_json, gt_png, pr_png)))
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    got = vpq_eval_all(videos, CATEGORIES, output_dir=str(tmp_path / "torch"))
    want = j_vpq_eval_all(videos, CATEGORIES, output_dir=str(tmp_path / "jax"))
    assert got == want
    assert 0.0 < want[0] < 100.0
    for k in ("0", "5", "10", "15", "final"):
        name = f"vpq-{k}.txt"
        assert filecmp.cmp(tmp_path / "torch" / name, tmp_path / "jax" / name,
                           shallow=False), name
