"""The program's spans against a made-up profile (benchlib/spans.py): a
device event goes to the span its launch call sat in, whenever it ran;
idle gaps go to the span open on the host at their midpoint, under the
harness part; the synchronising calls are counted by span inside the
harness's parts; the timed operations (portbench.op.*) are left out; the
calibration reads the offset of the spans' clock mapping; set-up spans
sum by name; a program without the tracer gives no Tracing; and
trace.reduce reads the same with the tracer on."""

import types

import pytest
from torch.autograd import DeviceType

from benchlib import spans, trace

#: the profiler's trace start on CLOCK_REALTIME, and CLOCK_REALTIME minus
#: CLOCK_MONOTONIC at the calibration
T0 = 1_700_000_000_000_000_000
REAL_MINUS_MONO = 1_699_000_000_000_000_000


def _ev(name, a, b, dev=False, id=0):
    return types.SimpleNamespace(
        name=name, id=id, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def _mono(us):
    """The tracer's perf_counter_ns at profiler time `us` (µs)."""
    return T0 + int(us * 1000) - REAL_MINUS_MONO


class _Tracer:
    def __init__(self, records, counters):
        self.records, self.counters, self.dropped = records, counters, 0


def _profile():
    events = [
        _ev("portbench.slice", 100, 2000),
        _ev("portbench.step", 110, 900),
        _ev("cudaLaunchKernel", 160, 165, id=11),      # in limit
        _ev("cudaLaunchKernel", 330, 335, id=12),      # in face_pass
        _ev("cudaLaunchKernel", 700, 705, id=13),      # in rk_update
        _ev("cudaMemcpyAsync", 710, 712, id=14),       # an upload ...
        _ev("cudaStreamSynchronize", 713, 760),        # ... and its wait
        _ev("portbench.read_it", 905, 930),
        _ev("cudaStreamSynchronize", 910, 925),
        _ev("portbench.diag", 935, 1900),
        _ev("cudaLaunchKernel", 950, 955, id=15),      # in diag.sums
        _ev("cudaStreamSynchronize", 1500, 1510),      # in diag.read
        _ev("cudaDeviceSynchronize", 1950, 1990),      # the slice's end
        # kernels run later than their launches
        _ev("k_limit", 400, 500, dev=True, id=11),
        _ev("k_face", 510, 690, dev=True, id=12),
        _ev("k_rk", 720, 800, dev=True, id=13),
        _ev("Memcpy HtoD (Pageable -> Device)", 800, 805, dev=True, id=14),
        _ev("k_diag", 1000, 1100, dev=True, id=15),
        # a timed operation after the slice: left out
        _ev("portbench.op.face_pass", 3000, 4000),
        _ev("cudaLaunchKernel", 3010, 3015, id=16),
        _ev("k_op", 3100, 3400, dev=True, id=16),
    ]
    recs = [
        ["step", -1, _mono(120), _mono(880), 1],
        ["limit", 0, _mono(150), _mono(300), 1],
        ["face_pass", 0, _mono(320), _mono(600), 1],
        ["rk_update", 0, _mono(650), _mono(870), 1],
        ["diag", -1, _mono(940), _mono(1800), 1],
        ["diag.sums", 4, _mono(945), _mono(1400), 1],
        ["diag.read", 4, _mono(1450), _mono(1790), 1],
    ]
    counters = {("host_syncs", ("step", "rk_update")): 1,
                ("host_syncs", ("diag", "diag.read")): 1}
    tracing = types.SimpleNamespace(slice=_Tracer(recs, counters),
                                    calib=(_mono(100) - 30_000,
                                           REAL_MINUS_MONO))
    prof = types.SimpleNamespace(
        events=lambda: events,
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: T0)))
    return prof, tracing


def test_kernels_go_to_the_span_of_their_launch():
    prof, tracing = _profile()
    r = spans.reduce(prof, tracing, 1)
    s = r["spans"]
    assert s["limit"]["device_s"] == pytest.approx(100e-6)
    assert s["face_pass"]["device_s"] == pytest.approx(180e-6)
    # the kernel and the upload of rk_update, and the step around all
    assert s["rk_update"]["device_s"] == pytest.approx(85e-6)
    assert s["step"]["device_s"] == pytest.approx(365e-6)
    assert s["diag"]["device_s"] == pytest.approx(100e-6)
    assert s["diag.read"]["device_s"] == 0.0
    assert s["step"]["calls"] == 1
    assert s["face_pass"]["host_s"] == pytest.approx(280e-6)
    assert r["step_device_s"] == pytest.approx(365e-6)
    assert r["step_named_s"] == pytest.approx(365e-6)
    # the operation's kernel is in no span and not in the slice
    assert r["linked"] == 5 and r["unlinked"] == 0


def test_idle_gaps_by_span_and_part():
    prof, tracing = _profile()
    r = spans.reduce(prof, tracing, 1)
    idle = r["idle_by_span"]
    # 500-510 (midpoint 505: face_pass), 690-720 (705: rk_update),
    # 805-1000 (902.5: between step and read_it), 1100-... none after
    assert idle == pytest.approx({
        "portbench.step/face_pass": 10e-6,
        "portbench.step/rk_update": 30e-6,
        "-/-": 195e-6})
    assert r["idle_s"] == pytest.approx(235e-6)


def test_sync_calls_by_span_inside_the_harness_parts():
    prof, tracing = _profile()
    r = spans.reduce(prof, tracing, 1)
    # the slice's closing synchronize lies in no harness part
    assert r["sync_calls"] == {"portbench.step/rk_update": 1,
                               "portbench.read_it/-": 1,
                               "portbench.diag/diag.read": 1}
    assert r["counters"] == {"host_syncs": 2}
    assert r["counter_by_span"] == {"host_syncs": {"rk_update": 1,
                                                   "diag.read": 1}}


def test_calibration_finds_the_clock():
    prof, tracing = _profile()
    entered = (_mono(100) + 20_000) / 1e9      # read inside the range
    c = spans.reduce(prof, tracing, 1, entered=entered)["calibration"]
    assert c["offset_us"] == pytest.approx(30.0)
    assert c["bracket_us"] == pytest.approx(50.0, abs=0.5)
    # a profiler on another clock than CLOCK_REALTIME shows as an offset
    # of the clocks' whole difference
    prof.profiler.kineto_results.trace_start_ns = \
        lambda: T0 - REAL_MINUS_MONO
    c = spans.reduce(prof, tracing, 1)["calibration"]
    assert c["offset_us"] == pytest.approx(30.0 - REAL_MINUS_MONO / 1e3)


def test_no_tracing_without_set_tracer(monkeypatch):
    # an older program without the tracer: a traced run reads no spans
    from quinoa_tpu_torch.base import profiler

    assert isinstance(spans.tracing(), spans.Tracing)
    monkeypatch.delattr(profiler, "set_tracer")
    assert spans.tracing() is None


def test_setup_spans_by_name():
    recs = [["build", -1, 0, 12_000, 0],
            ["geometry", 0, 1_000, 11_000, 0],
            ["geometry.upload", 1, 9_000, 10_500, 0],
            ["reorder", -1, 20_000, 0, 0]]          # never closed
    tracing = types.SimpleNamespace(setup=_Tracer(
        recs, {("kernels_built", ("build",)): 1,
               ("host_syncs", ("build", "geometry")): 2}))
    su = spans.setup_reduce(tracing)
    assert sorted(su["spans"]) == ["build", "geometry", "geometry.upload"]
    for name, host_s in (("build", 12e-6), ("geometry", 10e-6),
                         ("geometry.upload", 1.5e-6)):
        assert su["spans"][name]["host_s"] == pytest.approx(host_s)
        assert su["spans"][name]["calls"] == 1
    assert su["counters"] == {"kernels_built": 1, "host_syncs": 2}


def test_trace_reduce_unchanged_by_the_program_spans():
    """The spans leave no event in the profile: trace.reduce reads the
    same before and after spans.reduce, and a real session around a
    traced step holds none of the program's span names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quinoa_tpu_torch.base.profiler import PhaseProfiler, span, tracing

    prof, tr = _profile()
    before = trace.reduce(prof, 1, 1.9e-3)
    spans.reduce(prof, tr, 1)
    assert trace.reduce(prof, 1, 1.9e-3) == before
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with tracing(PhaseProfiler()):
            with span("step"):
                with span("limit"):
                    x = x * 2.0
    names = {e.name for e in p.events()}
    assert "aten::mul" in names and not names & {"step", "limit"}
