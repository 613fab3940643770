"""The traced run's reduction on a hand-made profile: device time by layer
(the accel range, K1 by name, the autograd engine's backward), the busy
union, range annotations left out, idle gaps named by the host."""
from collections import namedtuple

import pytest
import torch

from perfbench import spec, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
Kernel = namedtuple("Kernel", "name device duration")
Span = namedtuple("Span", "start end")


class Ev:
    def __init__(self, name, start, end, thread=1, device=CPU, kernels=()):
        self.name, self.thread, self.device_type = name, thread, device
        self.time_range = Span(start, end)
        self.kernels = [Kernel(k, 0, d) for k, d in kernels]
        self.is_async = False


BWD = trace.BACKWARD + ": MulBackward0"
EVENTS = [
    Ev(trace.ACCEL, 0, 100),
    Ev("aten::sort", 10, 20, kernels=[("sortk", 30)]),
    Ev("aten::mul", 150, 160, kernels=[("mulk", 20)]),
    Ev(BWD, 200, 300, thread=2),
    Ev("aten::mul", 210, 215, thread=2, kernels=[("mulk2", 40)]),
    Ev("sortk", 25, 55, device=CUDA),
    Ev("visit_scan_kernel<128, true>", 60, 90, device=CUDA),
    Ev(trace.ACCEL, 25, 90, device=CUDA),        # the range's annotation
    Ev("mulk", 160, 180, device=CUDA),
    Ev("mulk2", 220, 260, device=CUDA),
]


def test_reduce_by_layer():
    got = trace.reduce(EVENTS, 400e-6, 1)
    assert got["launches"] == 4
    assert got["attributed"] == pytest.approx(1.0)
    assert got["busy_s"] == pytest.approx(120e-6)
    ms = got["ms"]
    assert ms["k1"] == pytest.approx(0.030)
    assert ms["accel"] == pytest.approx(0.030)
    assert ms["integrator"] == pytest.approx(0.060)
    assert ms["backward"] == pytest.approx(0.040)
    assert ms["forward"] == pytest.approx(0.080)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({trace.ACCEL: 5e-6, "idle": 70e-6,
                                  BWD: 40e-6})
    name, seconds = got["breakdown"]["device_ops"][0]
    assert name == "mulk2" and seconds == pytest.approx(40e-6)


def test_readers_on_the_reduction():
    layers = trace.reduce(EVENTS, 400e-6, 2)
    read = {m["name"]: spec.reader(m["name"])(layers)
            for m in spec.benchmark()["per_layer"]}
    assert read["idle_pct.preview"] == pytest.approx(70.0)
    assert read["kernels_per_frame"] == 2
    assert read["backward_ms"] == pytest.approx(0.020)
    assert read["k1_roofline"] is None        # no replay in this profile
