"""Spans, counters and the torch trace.

The port's own copy of quinoa_tpu/base/profiler.py, grown into the port's
one tracer.  PhaseProfiler is the analog of the reference's timer table
printed by Main at the end of a run (src/Main/Inciter.cpp timers: mesh
read, partition, time stepping).  Each ``phase(name)`` is a span: its
name, its parent (the span open around it), its host start and end on
``time.perf_counter_ns()`` (CLOCK_MONOTONIC) and the step it belongs to,
a number the tracer advances at each ``step`` span.  Spans nest; the
table gives each span path its total, its self time (total less the time
its children cover) and its entries, then the counters.  A span times
device work only where the code inside it waits for the device.

The solver library opens its spans through the module-level ``span(name)``
and counts through ``count(name)``.  The module-level tracer is off unless
``set_tracer`` installs one (the inciter command does for --profile and
--trace-dir): off, ``span`` is one global check that returns a shared
no-op, and ``count`` returns at once.  A counter hit is attributed to the
innermost open span.  The counters:

- ``host_syncs``: a place where the host waits on the card: a read back
  of a device tensor (``float``, ``bool``, ``.item()``, ``.cpu()``) or a
  copy of a host table onto the device, counted at the site whatever the
  device (on the CPU the site waits for nothing);
- ``kernels_built``: nvcc builds of the CUDA library in this process;
- ``pref_p0_elements``: the elements at P0 of a p-adaptive state, from
  the read that the DG diagnostics' mixed P0/P1 test makes anyway (a
  shard counts its ghosts too).

Kernel launches stay in ``kernels.launches``; the table reports them.

``torch_trace`` wraps a block in torch.profiler, the counterpart of the
JAX package's jax_trace (the reference's Charm++ Projections analog): the
host's operators and, on the card, every kernel launched, written as a
Chrome trace, with the module-level tracer's spans of the block merged in
as a track of their own on the profiler's clock.

Spans are no ``torch.profiler.record_function`` ranges: a range also
leaves an annotation on the device's timeline, which is not device work.
No span may stay open across a ``yield`` of a step coroutine
(base/lockstep.py): shards step in lockstep, and their spans would
interleave.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

#: the span whose entries advance the tracer's step number
STEP = "step"


class _Null:
    """The shared no-op span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()

#: the module-level tracer (a PhaseProfiler), None while tracing is off
_TRACER = None


def span(name: str):
    """A span of the module-level tracer around a block, or the shared
    no-op while tracing is off."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.phase(name)


def count(name: str, n: int = 1):
    """Add n to counter ``name`` of the module-level tracer, attributed to
    its innermost open span; nothing while tracing is off."""
    t = _TRACER
    if t is not None:
        t.count(name, n)


def set_tracer(prof: Optional["PhaseProfiler"]):
    """Install prof as the module-level tracer (None turns tracing off);
    returns the tracer it replaces."""
    global _TRACER
    prev, _TRACER = _TRACER, prof
    return prev


@contextlib.contextmanager
def tracing(prof: Optional["PhaseProfiler"]):
    """Install prof as the module-level tracer for a block (no change when
    prof is None)."""
    if prof is None:
        yield
        return
    prev = set_tracer(prof)
    try:
        yield prof
    finally:
        set_tracer(prev)


class _Span:
    __slots__ = ("prof", "name", "path", "rec", "t0", "child")

    def __init__(self, prof, name):
        self.prof, self.name = prof, name

    def __enter__(self):
        p = self.prof
        parent = p._stack[-1] if p._stack else None
        self.path = (parent.path if parent else ()) + (self.name,)
        if self.name == STEP:
            p.step += 1
        if len(p.records) < p.MAX_RECORDS:
            self.rec = len(p.records)
            p.records.append([self.name, parent.rec if parent else -1, 0, 0,
                              p.step])
        else:
            self.rec = -1
            p.dropped += 1
        self.child = 0
        p._stack.append(self)
        self.t0 = time.perf_counter_ns()
        if self.rec >= 0:
            p.records[self.rec][2] = self.t0
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        p = self.prof
        if p._stack[-1] is not self:
            if exc_type is None:
                raise RuntimeError(f"span {self.name!r} closed while "
                                   f"{p._stack[-1].name!r} is open inside "
                                   "it: spans must nest")
            while p._stack and p._stack[-1] is not self:
                p._stack.pop()
        p._stack.pop()
        dur = t1 - self.t0
        acc = p._acc.get(self.path)
        if acc is None:
            acc = p._acc[self.path] = [0, 0, 0]
            p._order.append(self.path)
        acc[0] += dur
        acc[1] += self.child
        acc[2] += 1
        if p._stack:
            p._stack[-1].child += dur
        if self.rec >= 0:
            p.records[self.rec][3] = t1
        return False


class PhaseProfiler:
    """Nested spans and counters with a wall-clock breakdown.

        prof = PhaseProfiler()
        with prof.phase("mesh read"):
            ...
        with prof.phase("timestep"):
            with prof.phase("step"):
                ...
        print(prof.table())

    Spans may be entered repeatedly (times and counts accumulate per span
    path).  ``records`` keeps one ``[name, parent record or -1, start ns,
    end ns, step]`` per span, at most ``MAX_RECORDS`` of them (later spans
    still add to the table and count in ``dropped``); ``counters`` maps
    (counter, span path) to its hits.
    """

    #: span records kept in memory (a long run keeps its table whole)
    MAX_RECORDS = 1 << 18

    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self._stack: List[_Span] = []
        self._acc: Dict[Tuple[str, ...], List[int]] = {}
        self._order: List[Tuple[str, ...]] = []
        self.records: List[list] = []
        self.dropped = 0
        self.step = 0
        self.counters: Dict[Tuple[str, Tuple[str, ...]], int] = {}

    def phase(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1):
        key = (name, self._stack[-1].path if self._stack else ())
        self.counters[key] = self.counters.get(key, 0) + n

    def counter(self, name: str) -> int:
        """Counter ``name`` summed over the spans it was attributed to."""
        return sum(v for (c, _), v in self.counters.items() if c == name)

    def times(self) -> List[Tuple[Tuple[str, ...], float, float, int]]:
        """[(span path, seconds, self seconds, entries)], each span after
        its parent, siblings in first-entry order."""
        kids: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
        for path in self._order:
            kids.setdefault(path[:-1], []).append(path)
        out = []

        def walk(parent):
            for path in kids.get(parent, ()):
                tot, child, n = self._acc[path]
                out.append((path, tot * 1e-9, (tot - child) * 1e-9, n))
                walk(path)

        walk(())
        return out

    def total(self) -> float:
        return (time.perf_counter_ns() - self._t0) * 1e-9

    def table(self) -> str:
        """Formatted breakdown, one line per span path, children indented
        under their parent, + the untimed rest and the total (the layout
        of the reference's end-of-run timer printout), then the counters
        by span and the kernel launches."""
        tot = self.total()
        rows = [("  " * (len(p) - 1) + p[-1], s, ss, n)
                for p, s, ss, n in self.times()]
        w = max([len(r[0]) for r in rows] + [9])
        lines = [f"{'phase':<{w}}  {'sec':>9}  {'self':>9}  {'%':>5}  "
                 f"{'n':>6}"]
        for k, s, ss, n in rows:
            lines.append(f"{k:<{w}}  {s:9.3f}  {ss:9.3f}  "
                         f"{100.0 * s / tot:5.1f}  {n:6d}")
        top = sum(self._acc[p][0] for p in self._order if len(p) == 1) * 1e-9
        lines.append(f"{'(untimed)':<{w}}  {tot - top:9.3f}  {'':>9}  "
                     f"{100.0 * (tot - top) / tot:5.1f}")
        lines.append(f"{'total':<{w}}  {tot:9.3f}  {'':>9}  100.0")
        for name in sorted({c for c, _ in self.counters}):
            by = sorted(((v, "/".join(p) or "(no span)")
                         for (c, p), v in self.counters.items() if c == name),
                        reverse=True)
            lines.append(f"{name}: {self.counter(name)} ("
                         + ", ".join(f"{p} {v}" for v, p in by) + ")")
        from ..kernels import launches

        used = {k: v for k, v in launches.items() if v}
        if used:
            lines.append("kernel launches: " + ", ".join(
                f"{k} {v}" for k, v in sorted(used.items())))
        return "\n".join(lines)


#: the trace file torch_trace writes into its directory
TRACE_FILE = "trace.json"
#: the thread name of the program's spans in the trace
SPAN_TRACK = "program spans"


def clock_pair():
    """(perf_counter_ns, time_ns - perf_counter_ns) read back to back,
    the tightest of five tries: a span's time on CLOCK_REALTIME, the
    clock torch.profiler stamps its events with, is its time plus the
    second."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, a, r - (a + b) // 2)
    return best[1], best[2]


def _merge_spans(path, prof, t_lo, t_hi, real_minus_mono):
    """Add prof's spans that lie in [t_lo, t_hi] (perf_counter_ns) to the
    Chrome trace at path, as a track of their own on the trace's
    CLOCK_REALTIME."""
    import json
    import os

    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": SPAN_TRACK, "args": {"name": SPAN_TRACK}}]
    for name, _, a, b, step in prof.records:
        if b and t_lo <= a and b <= t_hi:
            events.append({"ph": "X", "cat": "span", "name": name,
                           "pid": pid, "tid": SPAN_TRACK,
                           "ts": (a + real_minus_mono - base) / 1000.0,
                           "dur": (b - a) / 1000.0, "args": {"step": step}})
    doc["traceEvents"].extend(events)
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def torch_trace(logdir: Optional[str], cuda: bool = False):
    """Wrap a block in torch.profiler when logdir is set (no-op
    otherwise): CPU activity, and CUDA activity with cuda (a run on the
    card), written to logdir/TRACE_FILE as a Chrome trace (chrome://
    tracing, Perfetto), with the module-level tracer's spans inside the
    block as the "program spans" track.  On the card the window opens and
    closes with the card idle, so the trace holds the block's device work
    whole and nothing queued before it."""
    if not logdir:
        yield
        return
    import os

    import torch
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if cuda:
        acts.append(tp.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    t_lo, real_minus_mono = clock_pair()
    with tp.profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    t_hi = time.perf_counter_ns()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if _TRACER is not None:
        _merge_spans(path, _TRACER, t_lo, t_hi, real_minus_mono)
