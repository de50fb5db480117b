"""The yardstick's arithmetic against hand counts at small shapes."""

import pytest
import torch

import flops
import roofline
import trace


def test_correlation_bounds_by_hand():
    # (1, 4, 8, 16), md 1: D^2 = 9; bytes (2*512 + 288) * 4, flops 2*32*9*16
    ms, by = roofline.correlation_bound_ms((1, 4, 8, 16), 1, 1, "float32")
    assert by == "bytes"
    assert ms == pytest.approx((2 * 512 + 32 * 9) * 4 / 3.35e12 * 1e3)
    ms, by = roofline.correlation_bound_ms((1, 64, 128, 256), 20, 2,
                                           "bfloat16")
    d2 = 21 ** 2
    flop_ms = 2 * 64 * 128 * d2 * 256 / 989e12 * 1e3
    byte_ms = (2 * 64 * 128 * 256 + 64 * 128 * d2) * 2 / 3.35e12 * 1e3
    assert ms == pytest.approx(max(flop_ms, byte_ms))
    ms, _ = roofline.correlation_backward_bound_ms((1, 200, 400, 256), 4, 1,
                                                   "float32")
    px = 200 * 400
    assert ms == pytest.approx(max(4 * px * 81 * 256 / 67e12,
                                   (4 * px * 256 + px * 81) * 4 / 3.35e12)
                               * 1e3)


def test_windowed_bound_by_hand():
    ms, by = roofline.windowed_bound_ms(1, 10, 10, 8, 4, "float32")
    byte_s = (100 * (8 * 4 + 18 * 4 + 4 * 4) + 9 * 8 * 4 * 4) / 3.35e12
    op_s = max(2 * 100 * 8 * 9 * 4 / 67e12, 8 * 100 * 9 * 4 / 67e12)
    assert ms == pytest.approx(max(byte_s, op_s) * 1e3)


def test_flops_count_convs_and_matmuls_by_bucket():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    lin = torch.nn.Linear(16, 4, bias=False)
    with flops.Counter() as c:
        conv(torch.randn(1, 3, 5, 5))
        lin((torch.randn(2, 16).bfloat16() @ torch.eye(16).bfloat16()).float())
    # the conv, and the linear layer's 2x16 by 16x4 in f32
    assert c.flops["float32"] == 2 * 25 * 8 * 3 * 9 + 2 * 2 * 16 * 4
    # the bf16 product 2x16 by 16x16
    assert c.flops["bfloat16"] == 2 * 2 * 16 * 16
    assert flops.correlation_flops((1, 4, 8, 16), 1, 1) == 2 * 32 * 9 * 16
    assert flops.correlation_flops((1, 4, 8, 16), 1, 1, backward=True) == \
        4 * 32 * 9 * 16


def test_flops_follow_the_configured_tower_dtype():
    class Tower(torch.nn.Module):
        compute_dtype = torch.bfloat16

        def forward(self, x):
            return x @ x  # an f32 product inside a bf16 tower

    tower = Tower()
    with flops.Counter(tower) as c:
        tower(torch.randn(4, 4))
    c.close()
    assert c.flops == {"bfloat16": 2 * 4 * 4 * 4, "float32": 0.0}
    assert flops.least_seconds({"bfloat16": 989e12, "float32": 67e12}) == 2.0


def _trace(kernels, window, ranges=None):
    return trace.make(kernels, ranges or {}, 0, window)


def test_device_idle_takes_the_union_of_overlapping_kernels():
    # two streams: [0, 40) and [20, 60) overlap; [80, 90) alone
    tr = _trace([("a", 0, 40), ("b", 20, 60), ("c", 80, 90)], (0, 100))
    assert tr.busy == [(0, 60), (80, 90)]
    assert tr.by_name == {"a": (40, 1), "b": (40, 1), "c": (10, 1)}
    assert trace.kernel_seconds(tr, ("a", "c")) == (50e-9, 2)
    assert trace.busy_seconds(tr) == pytest.approx(70e-9)
    from run import Context, reader
    ctx = Context(tr, None, {}, None, None)
    assert reader("device_idle.video")(ctx) == pytest.approx(30.0)


def test_idle_gaps_are_labelled_by_the_host_range():
    tr = _trace([("k", 0, 10), ("k", 50, 60)], (0, 100),
                {"semantic_head": [(1, 10, 50)], trace.WINDOW: [(1, 0, 100)]})
    gaps = dict(trace.idle_gaps(tr))
    assert gaps["semantic_head"] == pytest.approx(40e-9)
    assert gaps["host outside the program's ranges"] == pytest.approx(40e-9)


class _Event:
    def __init__(self, name, dev, t0, dur, annotation=False, tid=1):
        self._v = (name, dev, t0, dur, annotation, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_a_range_on_the_card_is_no_kernel():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event(trace.WINDOW, cpu, 0, 100),
              _Event("rpn", cpu, 0, 50), _Event(trace.SYNC, cpu, 10, 1),
              _Event("neck", cuda, 0, 100, annotation=True),
              _Event("rpn", cuda, 0, 50, annotation=True),
              _Event("gemm", cuda, 20, 10)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    tr = trace.read(Prof, {"rpn"})
    assert tr.by_name == {"gemm": (10, 1)} and tr.busy == [(20, 30)]
    assert tr.ranges["rpn"] == [(1, 0, 50)] and tr.syncs == 1
    assert tr.window == (0, 100)


def test_mfu_divides_by_the_busy_time_not_the_window():
    # 70 ns busy in a 100 ns window, 2 units of 1 s at the bf16 peak each
    from entries import Window
    from run import Context, reader
    tr = _trace([("a", 0, 40), ("b", 20, 60), ("c", 80, 90)], (0, 100))
    w = Window()
    w.units, w.seconds = 2, 100e-9
    ctx = Context(tr, w, {}, None, {"bfloat16": 17.5e-9 * 989e12,
                                    "float32": 0.0})
    # least time a unit 17.5 ns, busy 35 ns a unit
    assert reader("mfu.video")(ctx) == pytest.approx(50.0)
