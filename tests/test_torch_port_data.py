"""Port parity, the data pipeline: vps_torch.data against vps_tpu.data on
the same synthetic Cityscapes-VPS fixture, exactly. The fixture generator
writes byte-identical files; the dataset's train samples (for several
indices and RandomState seeds: resize jitter, flip, crop, padding, pids)
and test samples equal the JAX package's in arrays and metas; the loader's
epochs equal the JAX loader's with 0 workers and with 2 spawned ones; the
port's configs (and ``zoo.tiny_test_cfg``) equal the JAX package's as
dicts; the RLE decoder
equals the JAX package's.
"""

import filecmp
import os
from pathlib import Path

import numpy as np
import pytest

from vps_tpu import zoo as jzoo
from vps_tpu.config import Config as JConfig
from vps_tpu.data.dataset import build_dataset as j_build_dataset
from vps_tpu.data.loader import build_loader as j_build_loader
from vps_tpu.data.synth import make_synth_vps as j_make_synth_vps
from vps_tpu.native import rle_decode as j_rle_decode, rle_encode as j_rle_encode

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.config import Config
from vps_torch.data import build_dataset, build_loader
from vps_torch.data.coco import ann_to_mask
from vps_torch.data.synth import make_synth_vps

REPO = Path(__file__).resolve().parents[1]
H, W = 128, 256
# the config's pipeline at half the frame: the same jitter, flip and crop
PIPE = dict(img_scale=(W, H), ratio_range=(0.8, 1.5), flip_ratio=0.5,
            crop_size=(96, 192), max_gt=8)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The port's fixture (2 train videos of 3 frames, 1 val video of 3) and
    the JAX package's, same arguments, in two roots."""
    roots = {}
    for name, make in (("torch", make_synth_vps), ("jax", j_make_synth_vps)):
        root = str(tmp_path_factory.mktemp(name))
        train = make(root, mode="train", n_videos=2, n_frames=3, H=H, W=W,
                     seed=3, first_video=101)
        val = make(root, mode="val", n_videos=1, n_frames=3, H=H, W=W, seed=4)
        roots[name] = (root, train, val)
    return roots


def _train_cfg(train):
    ann, img, seg = train
    return dict(type="RepeatDataset", times=2, dataset=dict(
        type="CityscapesVPSDataset", ann_file=ann, img_prefix=img,
        ref_prefix=img, seg_prefix=seg, ref_ann_file=ann, offsets=[-1, 1],
        semantic2label={**{i: i for i in range(19)}, -1: 255, 255: 255},
        pipeline=dict(PIPE)))


def _test_cfg(val):
    ann, img, _ = val
    return dict(type="CityscapesVPSDataset", ann_file=ann, img_prefix=img,
                ref_prefix=img, nframes_span_test=3, test_mode=True,
                pipeline=dict(img_scale=(W, H)))


def _equal(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_synth_fixture_is_byte_identical(fixture):
    root, jroot = fixture["torch"][0], fixture["jax"][0]
    files = sorted(p.relative_to(root) for p in Path(root).rglob("*")
                   if p.is_file())
    jfiles = sorted(p.relative_to(jroot) for p in Path(jroot).rglob("*")
                    if p.is_file())
    assert files == jfiles and len(files) == 2 + 4 * 9
    for f in files:
        assert filecmp.cmp(Path(root, f), Path(jroot, f), shallow=False), f


def test_train_and_test_samples_match_jax(fixture):
    train, val = fixture["torch"][1], fixture["torch"][2]
    ds, jds = build_dataset(_train_cfg(train)), j_build_dataset(_train_cfg(train))
    assert ds.repeat_times == jds.repeat_times == 2 and len(ds) == len(jds) == 6
    n = 0
    for idx in range(6):
        for seed in (0, 1, 7):
            got = ds.prepare_train(idx, np.random.RandomState(seed))
            want = jds.prepare_train(idx, np.random.RandomState(seed))
            _equal(got, want)
            n += want is not None
    assert n >= 12
    ts, jts = build_dataset(_test_cfg(val)), j_build_dataset(_test_cfg(val))
    for idx in range(3):
        _equal(ts.prepare_test(idx), jts.prepare_test(idx))
        assert ts.prepare_test(idx)[2]["is_first"] == (idx == 0)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_epochs_match_jax(fixture, workers):
    """Both epochs of the port's loader (0 workers, or 2 spawned ones)
    against the JAX loader's serial path, same seed."""
    train = fixture["torch"][1]
    jl = j_build_loader(j_build_dataset(_train_cfg(train)), 2, seed=5,
                        num_workers=0)
    loader = build_loader(build_dataset(_train_cfg(train)), 2, seed=5,
                          num_workers=workers)
    try:
        assert loader.steps_per_epoch() == jl.steps_per_epoch() == 6
        for e in (0, 1):
            got, want = list(loader.epoch(e)), list(jl.epoch(e))
            assert len(got) == len(want) == 6
            for g, w in zip(got, want):
                _equal(g, w)
                assert g["img"].shape == (2, 96, 192, 3)
    finally:
        loader.close()
    assert not loader._procs


def test_config_matches_jax():
    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(plain(v) for v in x)
        return x

    for name in ("fusetrack.py", "fusetrack_fast.py"):
        got = Config.fromfile(str(REPO / "vps_torch/configs/cityscapes" / name))
        want = JConfig.fromfile(str(REPO / "configs/cityscapes" / name))
        assert plain(dict(got._cfg)) == plain(dict(want._cfg)), name
    assert zoo.tiny_test_cfg() == jzoo.tiny_test_cfg()


def test_rle_decode_matches_jax():
    """Compressed RLE strings (the JAX package's encoder), uncompressed
    counts, and polygons through ann_to_mask."""
    rng = np.random.RandomState(0)
    for h, w in ((7, 5), (40, 33), (64, 128)):
        mask = (rng.rand(h, w) > 0.6).astype(np.uint8)
        mask[:3] = 1
        counts = j_rle_encode(mask)
        got = ann_to_mask({"counts": counts, "size": [h, w]}, h, w)
        np.testing.assert_array_equal(got, j_rle_decode(counts, h, w))
        np.testing.assert_array_equal(got, mask)
        runs = [3, 10, 4, h * w - 17]
        np.testing.assert_array_equal(
            ann_to_mask({"counts": runs, "size": [h, w]}, h, w),
            j_rle_decode(runs, h, w))
    poly = [[2.0, 3.0, 20.5, 3.0, 20.5, 15.2, 2.0, 15.2]]
    from vps_tpu.data.coco import ann_to_mask as j_ann_to_mask
    np.testing.assert_array_equal(ann_to_mask(poly, 32, 32),
                                  j_ann_to_mask(poly, 32, 32))
