"""The trace's reduction on a made-up profile: the slice's numbers come
from the events inside the harness's slice range alone, and an operation's
device time is the union of the kernels inside its range, the host-device
copies left out; where the trace has a range's interval on the device's
timeline, device events are placed by it, not by the host's clock."""

import types

from torch.autograd import DeviceType

from benchlib import trace


def _ev(name, a, b, dev=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_slice_and_operations_apart():
    events = [
        _ev("portbench.slice", 0, 1000),
        _ev("portbench.step", 10, 500),
        _ev("cudaLaunchKernel", 20, 25),
        _ev("cudaLaunchKernel", 30, 35),
        _ev("k1", 100, 300, dev=True),
        _ev("k2", 250, 400, dev=True),
        _ev("k1", 600, 700, dev=True),
        # an operation's two calls, each with a copy and a gap
        _ev("portbench.op.face_pass", 2000, 3000),
        _ev("cudaLaunchKernel", 2010, 2015),
        _ev("Memcpy HtoD (Pageable -> Device)", 2050, 2450, dev=True),
        _ev("kf", 2100, 2200, dev=True),
        _ev("kf", 2500, 2600, dev=True),
        _ev("portbench.op.face_pass", 4000, 5000),
        _ev("kf", 4100, 4400, dev=True),
        _ev("fill", 1500, 1900, dev=True),     # the L2 flush, outside
    ]
    r = trace.reduce(types.SimpleNamespace(events=lambda: events), 2, 1e-3)
    assert r["launches"] == 2
    assert abs(r["busy_s"] - 400e-6) < 1e-12          # (100, 400) + (600, 700)
    k = dict(r["kernels"])
    assert set(k) == {"k1", "k2"}
    assert abs(k["k1"] - 300e-6) < 1e-12 and abs(k["k2"] - 150e-6) < 1e-12
    med, lo, hi = r["ops"]["face_pass"]
    assert (lo, hi) == (0.2, 0.3) and abs(med - 0.25) < 1e-12


def test_device_ranges_place_kernels_when_clocks_disagree():
    """The device's clock reads 50 units early: by the host's ranges the
    first kernel of each call would fall outside; by the device's own
    annotations it does not."""
    events = [
        _ev("portbench.slice", 0, 1000),
        _ev("portbench.slice", 50, 650, dev=True),
        _ev("k1", 50, 650, dev=True),
        _ev("portbench.op.limit_volume", 2000, 3000),
        _ev("portbench.op.limit_volume", 1960, 2400, dev=True),
        _ev("ka", 1960, 2100, dev=True),
        _ev("kb", 2150, 2400, dev=True),
        _ev("fill", 1500, 1900, dev=True),
    ]
    r = trace.reduce(types.SimpleNamespace(events=lambda: events), 1, 1e-3)
    assert abs(r["busy_s"] - 600e-6) < 1e-12
    med, lo, hi = r["ops"]["limit_volume"]
    assert abs(med - 0.39) < 1e-12 and lo == hi == med
