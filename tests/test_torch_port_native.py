"""Port, the native host library (``vps_torch.native``, built here with
g++) against the JAX package's (``vps_tpu.native``) and against the port's
own numpy versions: the COCO RLE codec, greedy NMS, Soft-NMS (hard, linear,
gaussian) and the legacy +1 IoU matrix, on seeded masks and boxes. Cheap
tests only."""

import numpy as np
import pytest

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_tpu.native as jn
import vps_torch.native as tn
from vps_torch.data import coco
from vps_torch.eval import mean_ap


def _masks():
    """Seeded masks with the codec's edge cases: all zeros, all ones, only
    the first pixel, 1x1, runs longer than 31 (several characters a run)
    and runs shorter than the run two before (negative deltas)."""
    rng = np.random.RandomState(0)
    out = [np.zeros((6, 5), np.uint8), np.ones((6, 5), np.uint8),
           np.zeros((1, 1), np.uint8), np.ones((1, 1), np.uint8)]
    first = np.zeros((7, 9), np.uint8)
    first[0, 0] = 1
    out.append(first)
    out.append(tn.runs_to_mask([100, 3, 2000, 1, 40, 700, 2, 10000 - 2846],
                               100, 100))
    for h, w, p in ((40, 33, 0.6), (64, 128, 0.9), (300, 200, 0.2)):
        out.append((rng.rand(h, w) > p).astype(np.uint8))
        blocky = np.zeros((h, w), np.uint8)
        blocky[h // 4:h // 2, w // 3:] = 1
        blocky[-3:, :5] = 1
        out.append(blocky)
    return out


def test_rle_round_trips():
    """Each mask: the native encoder's string equals the numpy encoder's
    and the JAX package's; each decoder (native, numpy, JAX) gives the mask
    back; the strings hold multi-character runs and negative deltas."""
    strings = []
    for m in _masks():
        h, w = m.shape
        s = tn.rle_encode(m)
        assert s == tn.rle_encode_np(m) == jn.rle_encode(m)
        for decode in (tn.rle_decode, tn.rle_decode_np, jn.rle_decode):
            got = decode(s, h, w)
            assert got.dtype == np.uint8 and got.shape == (h, w)
            np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(tn.rle_decode(s.encode(), h, w), m)
        strings.append(s)
    chars = [ord(c) - 48 for s in strings for c in s]
    assert any(c & 0x20 for c in chars)  # a run spread over characters
    assert any(c & 0x10 and not c & 0x20 for c in chars)  # a negative end


def test_rle_decode_through_coco():
    """``data.coco`` decodes compressed RLE with the native library and
    uncompressed counts as runs, as the JAX package's does."""
    for m in _masks()[4:]:
        h, w = m.shape
        s = jn.rle_encode(m)
        np.testing.assert_array_equal(
            coco.ann_to_mask({"counts": s, "size": [h, w]}, h, w), m)
    runs = [3, 10, 4, 35 - 17]
    np.testing.assert_array_equal(coco.rle_decode(runs, 7, 5),
                                  jn.rle_decode(runs, 7, 5))
    assert coco.rle_decode is tn.rle_decode


def _dets(rng, n):
    """n boxes around a few clusters (overlapping, nested, identical,
    disjoint) with scores that tie."""
    centres = rng.rand(4, 2) * 300
    c = centres[rng.randint(0, 4, n)] + rng.randn(n, 2) * 12
    wh = 10 + rng.rand(n, 2) * 60
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1)
    boxes[1] = boxes[0]
    boxes[2] = [boxes[0, 0] + 2, boxes[0, 1] + 2, boxes[0, 2] - 2,
                boxes[0, 3] - 2]
    boxes[3] = boxes[0] + 1000
    scores = rng.randint(1, 9, n) / 8.0
    return np.concatenate([boxes, scores[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_cpu_nms(thresh):
    """The kept indices, in order, equal the numpy version's and the JAX
    package's; an empty input keeps nothing."""
    rng = np.random.RandomState(1)
    for n in (1, 5, 60, 300):
        d = _dets(rng, max(n, 4))[:n]
        keep = tn.cpu_nms(d, thresh)
        assert keep.dtype == np.int64
        np.testing.assert_array_equal(keep, tn.cpu_nms_np(d, thresh))
        np.testing.assert_array_equal(keep, jn.cpu_nms(d, thresh))
    assert tn.cpu_nms(np.zeros((0, 5), np.float32), 0.5).shape == (0,)


@pytest.mark.parametrize("method", ["hard", "linear", "gaussian"])
def test_cpu_soft_nms(method):
    """The kept indices equal the numpy version's and the JAX package's;
    the rescored dets equal the JAX package's bit for bit and the numpy
    version's (hard, linear) bit for bit or (gaussian) within 1e-6 of the
    score: numpy's float32 exp and the C library's differ by an ulp
    (measured up to 2.4e-7)."""
    rng = np.random.RandomState(2)
    for n in (1, 7, 80):
        d = _dets(rng, max(n, 4))[:n]
        dets, keep = tn.cpu_soft_nms(d, 0.3, 0.5, 1e-3, method)
        np_dets, np_keep = tn.cpu_soft_nms_np(d, 0.3, 0.5, 1e-3, method)
        j_dets, j_keep = jn.cpu_soft_nms(d, 0.3, 0.5, 1e-3, method)
        np.testing.assert_array_equal(keep, np_keep)
        np.testing.assert_array_equal(keep, j_keep)
        np.testing.assert_array_equal(dets, j_dets)
        np.testing.assert_array_equal(dets[:, :4], np_dets[:, :4])
        if method == "gaussian":
            np.testing.assert_allclose(dets[:, 4], np_dets[:, 4], rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(dets, np_dets)
        assert len(keep) == len(set(keep.tolist()))
    empty, kept = tn.cpu_soft_nms(np.zeros((0, 5), np.float32))
    assert empty.shape == (0, 5) and kept.shape == (0,)
    with pytest.raises(ValueError):
        tn.cpu_soft_nms_np(d, method="cubic")


def test_bbox_overlaps():
    """The IoU matrix equals the numpy version's and the JAX package's bit
    for bit (disjoint, touching, nested and identical boxes among them);
    ``eval.mean_ap`` computes it with the native library; empty inputs give
    empty matrices."""
    rng = np.random.RandomState(3)
    for n, m in ((37, 23), (1, 1), (200, 150)):
        a, b = _dets(rng, max(n, 4))[:n, :4], _dets(rng, max(m, 4))[:m, :4]
        got = tn.bbox_overlaps(a, b)
        assert got.dtype == np.float32 and got.shape == (n, m)
        np.testing.assert_array_equal(got, tn.bbox_overlaps_np(a, b))
        np.testing.assert_array_equal(got, jn.bbox_overlaps_np(a, b))
    assert mean_ap.bbox_overlaps is tn.bbox_overlaps
    empty = np.zeros((0, 4), np.float32)
    assert tn.bbox_overlaps(empty, b).shape == (0, len(b))
    assert tn.bbox_overlaps(a, empty).shape == (len(a), 0)


def test_build_failure_raises(monkeypatch, tmp_path):
    """No silent numpy fallback: without a build and without a compiler the
    call raises (the library loaded afresh, as in a new process)."""
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tn.bbox_overlaps(np.ones((1, 4), np.float32), np.ones((1, 4), np.float32))
