"""Port parity, detection evaluation: vps_torch.eval.mean_ap (the legacy
"+1" IoU, average_precision, tpfp_default, eval_map, eval_recalls), the
training meters of vps_torch.utils.metrics / timer and
vps_torch.tools.robustness_eval.aggregate against their vps_tpu
counterparts (numpy modules: no JAX model is built) on seeded inputs.

Every number is exactly equal: the port computes the same float32
operations in the same order (the IoU equals the JAX package's native C++
library bit for bit, and its numpy fallback).
"""

import itertools
import time

import numpy as np
import pytest

from vps_tpu import native as j_native
from vps_tpu.eval import mean_ap as j_mean_ap
from vps_tpu.utils import metrics as j_metrics
from vps_tpu.utils import timer as j_timer

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from repo_tools import tool
from vps_torch.eval import mean_ap
from vps_torch.tools.robustness_eval import aggregate
from vps_torch.utils import metrics, timer


def _boxes(rng, n, lo=0.0, hi=100.0, size=60.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0.0, size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _dets_near(rng, gts, n_extra):
    """Detections: each gt jittered (some far off), plus random boxes; the
    scores drawn from 8 levels so that ties occur."""
    jit = rng.normal(0.0, 4.0, gts.shape) * (rng.rand(len(gts), 1) < 0.8)
    boxes = np.concatenate([gts + jit.astype(np.float32),
                            _boxes(rng, n_extra)])
    scores = rng.randint(1, 9, len(boxes)) / 8.0
    return np.concatenate([boxes, scores[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("fallback", [False, True])
def test_bbox_overlaps(monkeypatch, fallback):
    """The port's IoU against vps_tpu's ``bbox_overlaps_np``: its native
    library and (``fallback``) its numpy branch; disjoint, touching, nested
    and identical boxes among them."""
    if fallback:
        monkeypatch.setattr(j_native, "_load", lambda: None)
    else:
        assert j_native._load() is not None
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = _boxes(rng, 37), _boxes(rng, 23)
        b[:5] = a[:5]  # identical
        b[5] = a[5] + np.float32(200)  # disjoint
        b[6] = [a[6, 2] + 1, a[6, 1], a[6, 2] + 9, a[6, 3]]  # touching
        got, want = mean_ap.bbox_overlaps(a, b), j_native.bbox_overlaps_np(a, b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (got[np.arange(5), np.arange(5)] == 1).all()
    empty = np.zeros((0, 4), np.float32)
    assert mean_ap.bbox_overlaps(empty, b).shape == (0, 23)
    np.testing.assert_array_equal(mean_ap.bbox_overlaps(a, empty),
                                  j_native.bbox_overlaps_np(a, empty))


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_average_precision(mode):
    """(N,) and (scales, N) curves, with repeated recalls."""
    rng = np.random.RandomState(1)
    for n in (1, 5, 40):
        rec = np.sort(rng.randint(0, 10, (3, n)) / 10.0, axis=1)
        prec = rng.rand(3, n)
        np.testing.assert_array_equal(
            mean_ap.average_precision(rec, prec, mode),
            j_mean_ap.average_precision(rec, prec, mode))
        got = mean_ap.average_precision(rec[0], prec[0], mode)
        assert got == j_mean_ap.average_precision(rec[0], prec[0], mode)
    with pytest.raises(ValueError):
        mean_ap.average_precision(rec, prec, "bogus")


def test_tpfp_default_with_ignores():
    rng = np.random.RandomState(2)
    for trial in range(30):
        gts = _boxes(rng, rng.randint(0, 7))
        dets = _dets_near(rng, gts, rng.randint(0, 6))
        ign = rng.rand(len(gts)) < 0.3 if trial % 3 else None
        for thr in (0.3, 0.5, 0.75):
            got = mean_ap.tpfp_default(dets, gts, ign, thr)
            want = j_mean_ap.tpfp_default(dets, gts, ign, thr)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_eval_map(mode, capsys):
    """Seeded dets and gts over 6 images and 5 classes: class 4 has no gt,
    class 2 no det in some images, every third gt ignored, scores tied; the
    mAP, the per-class results and the printed table equal."""
    rng = np.random.RandomState(3)
    dets, gts, labels, ignores = [], [], [], []
    for i in range(6):
        lab = rng.choice([1, 2, 3, 5], rng.randint(0, 9))
        g = _boxes(rng, len(lab))
        gts.append(g)
        labels.append(lab.astype(np.int64))
        ignores.append(np.arange(len(lab)) % 3 == 2)
        per_cls = []
        for c in range(5):
            near = _dets_near(rng, g[lab == c + 1], rng.randint(0, 4))
            per_cls.append(near if (c != 1 or i % 2) else near[:0])
        dets.append(per_cls)
    names = ("a", "b", "c", "d", "e")
    for ign in (None, ignores):
        for thr in (0.5, 0.7):
            got = mean_ap.eval_map(dets, gts, labels, ign, thr, mode, names)
            out = capsys.readouterr().out
            want = j_mean_ap.eval_map(dets, gts, labels, ign, thr, mode, names)
            assert got == want and out == capsys.readouterr().out
            assert got[1][3]["num_gts"] == 0 and 0 < got[0] < 1
    got = mean_ap.eval_map(dets, gts, labels, mode=mode, print_summary=False)
    assert got == j_mean_ap.eval_map(dets, gts, labels, mode=mode,
                                     print_summary=False)
    assert capsys.readouterr().out == ""


def test_eval_recalls():
    """Proposals with and without scores, images without gts or
    proposals."""
    rng = np.random.RandomState(4)
    gts, props = [], []
    for i in range(5):
        g = _boxes(rng, [3, 0, 6, 2, 4][i])
        p = _dets_near(rng, g, 30)
        gts.append(g)
        props.append(p if i % 2 else p[:, :4])
    props[3] = props[3][:0]
    for nums, thrs in (((1, 5, 40), (0.5,)), ((10, 300), (0.3, 0.5, 0.7, 0.9))):
        got = mean_ap.eval_recalls(gts, props, nums, thrs)
        want = j_mean_ap.eval_recalls(gts, props, nums, thrs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= 1


def test_meters_and_colormap(monkeypatch):
    """Timer (both modules), Speedometer and EvalMetric on one fake clock
    driven through the same calls on both sides; colormap(n)."""
    ticks = itertools.count(0.0, 0.25)
    clock = lambda: next(ticks)  # noqa: E731
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "perf_counter", clock)

    def drive_metrics(m):
        t = m.Timer()
        laps = [t.tic() or t.toc() for _ in range(3)]
        s = m.Speedometer(frequent=2)
        speeds = [s(batch_size=4) for _ in range(7)]
        e = m.EvalMetric("loss")
        e.update({"a": 1.5, "b": 2})
        e.update({"a": 0.5}, n=3)
        got = e.get()
        e.reset()
        return laps, t.total_time, t.calls, t.average_time, speeds, got, e.get()

    def drive_timer(m):
        t = m.Timer()
        with t:
            pass
        avg = t.tic().toc()
        diff = t.tic().toc(average=False)
        with pytest.raises(RuntimeError):
            m.Timer().toc()
        return avg, diff, t.total, t.calls, t.average, t.diff

    assert drive_metrics(metrics) == drive_metrics(j_metrics)
    assert drive_timer(timer) == drive_timer(j_timer)
    for n in (1, 79, 100):
        for rgb in (True, False):
            got, want = metrics.colormap(n, rgb), j_metrics.colormap(n, rgb)
            assert got.dtype == want.dtype and got.shape == (n, 3)
            np.testing.assert_array_equal(got, want)


def test_robustness_aggregate():
    """P, mPC, rPC and the per-corruption means of a report, and the
    failures (no clean run, no corruption run) the same as the repo
    tool's."""
    rng = np.random.RandomState(5)
    report = {"clean": dict(bbox_mAP=0.42, fps=3.0)}
    for c in ("gaussian_noise", "fog", "motion_blur"):
        for s in (1, 3, 5):
            report[f"{c}_s{s}"] = dict(bbox_mAP=float(rng.rand()), fps=2.0)
    report["fog_s2"] = dict(fps=1.0)  # no metric: skipped
    for metric in ("bbox_mAP", "fps"):
        assert aggregate(report, metric) == tool("robustness_eval").aggregate(
            report, metric)
    zero = dict(report, clean=dict(bbox_mAP=0.0))
    assert aggregate(zero) == tool("robustness_eval").aggregate(zero)
    for bad, err in (({"fog_s1": dict(bbox_mAP=0.1)}, KeyError),
                     ({"clean": dict(bbox_mAP=0.1)}, ValueError)):
        with pytest.raises(err):
            aggregate(bad)
        with pytest.raises(err):
            tool("robustness_eval").aggregate(bad)
