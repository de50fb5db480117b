"""Port, data-parallel training: what each rank does, with the rank
patched in one process (``vps_torch.train.dist.get_rank`` /
``get_world_size``, as ``tests/test_eval_hook.py`` patches JAX's process
index). The eval hook gives rank r the JAX hook's videos (v % 2 == r) and
its 2-rank merge equals the 1-rank results; a Runner at rank 1 writes no
checkpoint and logs nothing; ``get_root_logger`` is at ERROR on rank 1.
Stubs stand in for the detector and the datasets, so the tests are cheap."""

import logging
import types

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import jax
import vps_tpu.models.detectors as j_detectors
from vps_tpu.train.eval_hook import make_video_eval_hook as j_make_hook

import vps_torch.models.detectors as t_detectors
from vps_torch.train import dist
from vps_torch.train.eval_hook import make_video_eval_hook
from vps_torch.train.runner import Runner
from vps_torch.train.step import GT_KEYS, IMAGE_KEYS
from vps_torch.utils.checkpoint import latest_checkpoint
from vps_torch.utils.logging import close_root_logger, get_root_logger

NSPAN = 3


class _Videos:
    """10 frames in videos of 3 (the last video has 1); each frame's image
    is its index."""

    nframes_span_test = NSPAN

    def __len__(self):
        return 10

    def prepare_test(self, idx):
        img = np.full((2, 2, 3), idx, np.float32)
        return img, img, {"iid": f"{idx // NSPAN:04d}_{idx % NSPAN:04d}",
                          "is_first": idx % NSPAN == 0}


def _frame_step(seen):
    """A stand-in for ``make_frame_step``: a carry that counts the frames
    since the video's first, as the track state carries across frames."""

    def make(det, track_cap=256):
        carry = {"n": 0}

        def step(img, ref_img, is_first):
            carry["n"] = 0 if is_first else carry["n"] + 1
            seen.append(int(img[0, 0, 0]))
            return {"num_keep": torch.tensor(float(img[0, 0, 0] % 2)),
                    "fcn_outputs": torch.tensor([carry["n"], img[0, 0, 0]])}
        return step

    return make


def _patch_rank(monkeypatch, rank, world):
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)


def test_eval_hook_shards_videos_as_jax(tmp_path, monkeypatch):
    """Rank r of 2 runs the frames of the videos the JAX hook gives host r,
    each video in order from its first frame; rank 0's merge equals the
    1-rank hook's results, and rank 1 returns {}."""
    ds = _Videos()
    jax_frames = {}
    for host in (1, 0):
        seen = jax_frames.setdefault(host, [])

        def streams(detector, variables, frames, chunk, record, track_cap,
                    seen=seen):
            for img, is_first, meta in frames:
                seen.append(int(img[0, 0, 0]))
                record({"num_keep": np.float32(0)}, meta)

        monkeypatch.setattr(j_detectors, "run_video_streams", streams)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda host=host: host)
        hook = j_make_hook(None, ds, str(tmp_path / "jax"), barrier_timeout=5)
        hook(types.SimpleNamespace(params={}, batch_stats={}), 1)
    monkeypatch.undo()
    assert jax_frames == {0: [0, 1, 2, 6, 7, 8], 1: [3, 4, 5, 9]}

    port_frames, merged = {}, {}
    for rank in (1, 0):
        port_frames[rank] = []
        monkeypatch.setattr(t_detectors, "make_frame_step",
                            _frame_step(port_frames[rank]))
        _patch_rank(monkeypatch, rank, 2)
        hook = make_video_eval_hook(None, ds, str(tmp_path / "port"),
                                    evaluate=lambda r, e: merged.update(r) or
                                    {"frames": float(len(r))},
                                    barrier_timeout=5)
        metrics = hook(None, 1)
        assert metrics == ({"frames": 10.0} if rank == 0 else {})
    assert port_frames == jax_frames

    single = []
    monkeypatch.setattr(t_detectors, "make_frame_step", _frame_step(single))
    _patch_rank(monkeypatch, 0, 1)
    one_rank = {}
    make_video_eval_hook(None, ds, evaluate=lambda r, e: one_rank.update(r)
                         or {})(None, 1)
    assert single == list(range(10))
    assert sorted(merged) == sorted(one_rank)
    for k, v in one_rank.items():
        for key in v:
            np.testing.assert_array_equal(merged[k][key], v[key])


class _Toy(torch.nn.Module):
    """A detector with one weight and the training ``loss`` signature."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.device = torch.device("cpu")

    def loss(self, generator=None, **sample):
        return {"loss_x": (self.w * sample["img"].mean()).square().sum()}


class _Loader:
    def __init__(self):
        self.batch = {k: np.ones((1, 4, 4, 3) if k == "img" else (1, 2),
                                 np.float32) for k in IMAGE_KEYS + GT_KEYS}

    def steps_per_epoch(self):
        return 1

    def epoch(self, e):
        yield self.batch


@pytest.mark.parametrize("rank", [0, 1])
def test_runner_checkpoints_and_logs_on_rank0_only(tmp_path, monkeypatch,
                                                   rank):
    """The same Runner, 2 epochs: at rank 0 a checkpoint and the logged
    steps and metrics; at rank 1 neither, while it still trains and calls
    the eval hook every epoch."""
    _patch_rank(monkeypatch, rank, 1)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("vps_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    evals = []
    try:
        runner = Runner(_Toy(), _Loader(), {}, str(tmp_path), total_epochs=2,
                        log_interval=1, ckpt_interval=1,
                        eval_fn=lambda state, e: evals.append(e) or {"m": 1.0})
        state = runner.run()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(logging.NOTSET)
    assert state.step == 2 and evals == [1, 2]
    assert len(runner.log_history) == 2
    ckpt = latest_checkpoint(str(tmp_path))
    if rank == 0:
        assert ckpt.endswith("ckpt_2.pth")
        assert sum("Eval [" in r.getMessage() for r in records) == 2
        assert "images/s over 1 rank(s)" in records[0].getMessage()
    else:
        assert ckpt is None and records == []


@pytest.mark.parametrize("rank", [0, 1])
def test_root_logger_level_by_rank(tmp_path, monkeypatch, rank):
    """get_root_logger: INFO on rank 0, ERROR on every other rank, to the
    console and the log file; close_root_logger takes its handlers away."""
    _patch_rank(monkeypatch, rank, 2)
    log_file = tmp_path / "train.log"
    try:
        logger = get_root_logger(log_file=str(log_file))
        assert logger.level == (logging.INFO if rank == 0 else logging.ERROR)
        assert len(logger.handlers) == 2
        logger.info("info line")
        logger.error("error line")
    finally:
        close_root_logger()
    assert not logging.getLogger("vps_torch").handlers
    text = log_file.read_text()
    assert ("info line" in text) == (rank == 0)
    assert "error line" in text
