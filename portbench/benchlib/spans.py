"""The program's spans and counters in a traced run, and their reduction
against the run's one torch.profiler session.

The port (quinoa_tpu_torch/base/profiler.py) opens spans inside its step,
diagnostics and set-up and counts the places where the host waits on the
card, all on the host's time.perf_counter_ns() (CLOCK_MONOTONIC), with no
mark on the profiler's timeline.  Tracing turns its tracer on through
set-up and through the traced slice (not in the window), and reads one
calibration pair just before the harness opens the slice's range.  The
profiler stamps its events with CLOCK_REALTIME; the pair maps the spans
onto it, and the offset of the slice range's own start from the reading
taken just before it shows that the mapping holds.

reduce() ties each device event of the slice to the host runtime call
that issued it (the same correlation id), puts it in the innermost
program span open at that call's host time (and in every span around
that one), and sums each span's device time as the union of its events'
intervals.  Each idle gap between device activity goes to the innermost
program span open on the host at the gap's midpoint, under the harness
part open then.  The timed operations (portbench.op.*) lie outside the
slice and are left out.

The harness does not call this module yet: a traced run would call
tracing().setup_on() before set-up, off() before the window, slice_on()
inside the profiler session just before the slice's range, and off(),
reduce(), setup_reduce() and log_lines() after the slice, before the
profiler session is freed (PERF.md, Open questions)."""

from __future__ import annotations

import bisect

SLICE = "portbench.slice"
#: the range that opens the profiler session before the slice
WARM = "portbench.warm"
#: the harness's parts of the slice (window.py's labels)
PARTS = ("portbench.step", "portbench.read_it", "portbench.diag")
#: the spans that partition the program's step
STEP = "step"
STEP_CHILDREN = ("limit", "volume", "nonconservative", "face_pass", "dt",
                 "rk_update", "pref")
#: host runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
NONE = "-"


def tracing():
    """A Tracing of the port's tracer, or None where the program has none
    (no set_tracer): a traced run of an older program then reads no
    spans."""
    from quinoa_tpu_torch.base import profiler

    return Tracing(profiler) if hasattr(profiler, "set_tracer") else None


class Tracing:
    """The program's tracer through set-up and through the slice: one
    PhaseProfiler each."""

    def __init__(self, mod):
        self.mod = mod
        self.setup = self.slice = self.calib = None

    def _on(self):
        prof = self.mod.PhaseProfiler()
        self.mod.set_tracer(prof)
        return prof

    def setup_on(self):
        self.setup = self._on()

    def slice_on(self):
        """Inside the profiler session: one range of its own (the
        session's first event costs some hundreds of µs more than later
        ones, which would lie between the calibration and the slice's
        range), the tracer on, then the calibration pair: call it last
        before the slice's range opens."""
        from torch.profiler import record_function

        with record_function(WARM):
            pass
        self.slice = self._on()
        self.calib = self.mod.clock_pair()

    def off(self):
        self.mod.set_tracer(None)


def _union_s(iv):
    tot, hi = 0.0, None
    for a, b in sorted(iv):
        if hi is None or a > hi:
            tot += b - a
            hi = b
        elif b > hi:
            tot += b - hi
            hi = b
    return tot / 1e6


def _innermost(spans, times):
    """For each time of `times` (µs), the index of the innermost interval
    of `spans` [(a, b, idx)] (properly nested) holding it, or -1."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [-1] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else -1
    return out


def _by_name(records):
    """{name: {"host_s", "calls"}} of closed span records."""
    out = {}
    for name, _, a, b, _ in records:
        if b:
            d = out.setdefault(name, {"host_s": 0.0, "calls": 0})
            d["host_s"] += (b - a) * 1e-9
            d["calls"] += 1
    return out


def _counters(prof):
    """({counter: n}, {counter: {innermost span: n}})."""
    tot, by = {}, {}
    for (name, path), n in prof.counters.items():
        tot[name] = tot.get(name, 0) + n
        inner = path[-1] if path else NONE
        by.setdefault(name, {})
        by[name][inner] = by[name].get(inner, 0) + n
    return tot, by


def setup_reduce(tracing):
    """Set-up spans by name and the set-up counters."""
    return {"spans": _by_name(tracing.setup.records),
            "counters": _counters(tracing.setup)[0]}


def reduce(prof, tracing, steps, entered=None):
    """The slice's spans against the profiler's events.  entered:
    time.perf_counter() read just inside the slice's range, so that
    [calibration, entered] brackets its start.
    {calibration: {offset_us, bracket_us}, spans: {name:
    {device_s, host_s, calls}} (device time inclusive of child spans),
    counters: {counter: n}, counter_by_span, sync_calls: {part/span: n},
    idle_by_span: {part/span: s}, idle_s, step_device_s, step_named_s,
    linked, unlinked}."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    s0, s1 = next((e.time_range.start, e.time_range.end) for e in host
                  if e.name == SLICE)
    dev_sl = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and e.name == SLICE]

    # the spans on the profiler's CLOCK_REALTIME, and the slice range's
    # start against the reading taken just before it
    mono, real_minus_mono = tracing.calib
    start = prof.profiler.kineto_results.trace_start_ns()
    offset_us = (start + round(s0 * 1e3) - mono - real_minus_mono) / 1e3
    shift = real_minus_mono - start

    bracket_us = None if entered is None else \
        (round(entered * 1e9) - mono) / 1e3
    recs = tracing.slice.records
    spans = [((a + shift) / 1e3, (b + shift) / 1e3, i)
             for i, (_, _, a, b, _) in enumerate(recs) if b]
    names = [r[0] for r in recs]

    def chain(i):
        out = []
        while i >= 0:
            out.append(names[i])
            i = recs[i][1]
        return out

    parts = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.name in PARTS)
    pstarts = [p[0] for p in parts]

    def part_at(t):
        j = bisect.bisect_right(pstarts, t) - 1
        return parts[j][2] if j >= 0 and parts[j][1] >= t else NONE

    # device events tied to their host runtime calls by correlation id
    calls = {}
    for e in host:
        n = e.name
        if "Launch" in n or n.startswith(("cudaMemcpy", "cudaMemset")):
            calls[e.id] = e.time_range.start
    linked, unlinked, dev = [], 0, []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("portbench."):
            continue
        a, b = e.time_range.start, e.time_range.end
        if dev_sl:
            if dev_sl[0][0] <= a <= dev_sl[0][1]:
                dev.append((a, b))
        elif s0 <= a <= s1:
            dev.append((a, b))
        t = calls.get(e.id)
        if t is None:
            unlinked += s0 <= a <= s1
        elif s0 <= t <= s1:
            linked.append((t, a, b))
    inner = _innermost(spans, [t for t, _, _ in linked])
    per = {}
    step_dev = step_named = 0.0
    for (t, a, b), i in zip(linked, inner):
        ch = chain(i) if i >= 0 else []
        for n in set(ch):
            per.setdefault(n, []).append((a, b))
        if STEP in ch:
            step_dev += b - a
            if any(n in STEP_CHILDREN for n in ch):
                step_named += b - a
    out_spans = _by_name(recs)
    for n, d in out_spans.items():
        d["device_s"] = _union_s(per.get(n, ()))

    # idle gaps, by the harness part and the innermost span on the host
    merged = []
    for a, b in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    mids = [0.5 * (b0 + a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    gaps = [(a1 - b0) / 1e6 for (_, b0), (a1, _) in zip(merged, merged[1:])]
    idle = {}
    for t, g, i in zip(mids, gaps, _innermost(spans, mids)):
        k = f"{part_at(t)}/{names[i] if i >= 0 else NONE}"
        idle[k] = idle.get(k, 0.0) + g

    # the runtime calls that wait for the device, inside the harness's
    # parts (the synchronize that ends the slice is outside them)
    syncs = [e.time_range.start for e in host
             if s0 <= e.time_range.start <= s1
             and (e.name in SYNC_CALLS
                  or (e.name.startswith("cudaMemcpy") and "Async" not in e.name))]
    sync_calls = {}
    for t, i in zip(syncs, _innermost(spans, syncs)):
        p = part_at(t)
        if p == NONE:
            continue
        k = f"{p}/{names[i] if i >= 0 else NONE}"
        sync_calls[k] = sync_calls.get(k, 0) + 1
    counters, by = _counters(tracing.slice)
    return dict(
        calibration={"offset_us": offset_us, "bracket_us": bracket_us},
        spans=out_spans, counters=counters, counter_by_span=by,
        sync_calls=sync_calls, idle_by_span=idle, idle_s=sum(gaps),
        step_device_s=step_dev / 1e6, step_named_s=step_named / 1e6,
        linked=len(linked), unlinked=unlinked, steps=steps,
        dropped=tracing.slice.dropped)


def log_lines(sp, setup):
    """The log's lines of a reduce() result and of setup_reduce()."""
    out = []
    for n, d in sorted(setup["spans"].items(),
                       key=lambda kv: -kv[1]["host_s"]):
        out.append(f"setup span {n} host {d['host_s']:.6f} s, "
                   f"{d['calls']} calls")
    out.append(f"setup counters {setup['counters']}")
    c, n = sp["calibration"], sp["steps"]
    out.append(f"calibration: profiler clock CLOCK_REALTIME, slice range "
               f"starts {c['offset_us']:.3f} us after the tracer's reading"
               f" (the reading inside the range: {c['bracket_us']} us)")
    for name, d in sorted(sp["spans"].items(),
                          key=lambda kv: -kv[1]["device_s"]):
        out.append(f"span {name} device {1e3 * d['device_s'] / n:.6f} ms/step"
                   f" host {1e3 * d['host_s'] / n:.6f} ms/step calls "
                   f"{d['calls'] / n:.4f}/step")
    share = sp["step_named_s"] / sp["step_device_s"] \
        if sp["step_device_s"] else float("nan")
    out.append(f"step device time in named child spans {100 * share:.3f}% "
               f"of {1e3 * sp['step_device_s'] / n:.6f} ms/step; device "
               f"events tied to a launch {sp['linked']}, not {sp['unlinked']}")
    idle = sp["idle_s"] or float("nan")
    for k, v in sorted(sp["idle_by_span"].items(), key=lambda kv: -kv[1]):
        out.append(f"idle {k} {1e3 * v / n:.6f} ms/step "
                   f"({100 * v / idle:.2f}%)")
    nobody = sum(v for k, v in sp["idle_by_span"].items()
                 if k == f"{NONE}/{NONE}")
    out.append(f"idle in no harness part and no program span "
               f"{100 * nobody / idle:.3f}%")
    hs = sp["counters"].get("host_syncs", 0)
    prof_syncs = sum(sp["sync_calls"].values())
    harness = sum(v for k, v in sp["sync_calls"].items()
                  if k.endswith(f"/{NONE}"))
    out.append(f"host_syncs {hs / n:.4f}/step (+3 harness reads = "
               f"{hs / n + 3:.4f}); profiler's synchronising calls "
               f"{prof_syncs / n:.4f}/step: {(prof_syncs - harness) / n:.4f}"
               f" in program spans, {harness / n:.4f} in none (the "
               f"harness's reads)")
    for k, v in sorted(sp["counter_by_span"].get("host_syncs", {}).items()):
        out.append(f"host_syncs by span {k} {v / n:.4f}/step")
    for k, v in sorted(sp["sync_calls"].items()):
        out.append(f"sync calls by span {k} {v / n:.4f}/step")
    if sp["dropped"]:
        out.append(f"span records dropped {sp['dropped']}")
    return out

