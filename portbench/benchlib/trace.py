"""Reduction of the one torch.profiler session of a traced run.

The slice of steps (inside the harness's "portbench.slice" range): the
union of the device's activity intervals (chip_smoke.py profile_path's
arithmetic, copied), the runtime's kernel-launch calls, the device time by
kernel name and the idle gaps between device activity by what the host
was doing.  The timed operations (each call inside a "portbench.op.<name>"
range, on an idle card): the union of the call's kernels, copies and
fills between host and device left out; the median, min and max over the
calls.  A device event belongs to a range by the range's own interval on
the device's timeline (the profiler's annotation spanning the kernels
launched inside it), where the trace has one, since the host's and the
device's clocks are aligned only to some tens of microseconds; else by
the host's interval.  One session a process: a second session has been
seen to lose kernel records."""

from __future__ import annotations

import bisect
import statistics

SLICE = "portbench.slice"
OP = "portbench.op."


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _inside(ranges, starts, t):
    """Index of the range of `ranges` (sorted (a, b, name)) holding t, or
    -1."""
    j = bisect.bisect_right(starts, t) - 1
    return j if j >= 0 and ranges[j][1] >= t else -1


def reduce(prof, steps, wall_s, top=10):
    """{busy_s, window_s, launches, steps, device_ops, idle_gaps, kernels,
    placed_by, ops}: device_ops and idle_gaps are at most `top` [name,
    seconds] pairs, largest first; placed_by says by which timeline the
    slice's and the operations' device events were placed; ops is {name:
    (median, min, max) ms}."""
    from torch.autograd import DeviceType

    events = list(prof.events())

    def marks(device):
        return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if (e.device_type == DeviceType.CUDA) == device
                      and (e.name == SLICE or e.name.startswith(OP)))

    host_ranges, on_device = marks(False), marks(True)
    dev_ranges, placed_by = [], []
    for kind in (lambda n: n == SLICE, lambda n: n.startswith(OP)):
        own = [r for r in on_device if kind(r[2])]
        placed_by.append("device" if own else "host")
        dev_ranges += own or [r for r in host_ranges if kind(r[2])]
    dev_ranges.sort()
    rstarts = {id(r): [x[0] for x in r] for r in (host_ranges, dev_ranges)}

    def where(t, ranges):
        j = _inside(ranges, rstarts[id(ranges)], t)
        return None if j < 0 else (j, ranges[j][2])

    spans, by_name, launches, cpu, parts = [], {}, 0, [], []
    reps = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            if e.device_type != DeviceType.CUDA and e.name != SLICE \
                    and not e.name.startswith(OP):
                parts.append((a, b, e.name))
            continue
        device = e.device_type == DeviceType.CUDA
        at = where(a, dev_ranges if device else host_ranges)
        if at is None:
            continue
        j, rname = at
        if device:
            if rname == SLICE:
                spans.append((a, b))
                by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
            elif not e.name.startswith(("Memcpy", "Memset")):
                reps.setdefault((rname[len(OP):], j), []).append((a, b))
        elif rname == SLICE:
            if "LaunchKernel" in e.name:
                launches += 1
            cpu.append((a, b, e.name))
    merged = _union(spans)
    busy = sum(b - a for a, b in merged) / 1e6
    gaps = {}
    cpu.sort()
    parts.sort()
    starts = [c[0] for c in cpu]
    pstarts = [p[0] for p in parts]
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        what = _host_at(parts, pstarts, cpu, starts, 0.5 * (b0 + a1))
        gaps[what] = gaps.get(what, 0.0) + (a1 - b0) / 1e6
    per_op = {}
    for (name, _), iv in reps.items():
        per_op.setdefault(name, []).append(
            sum(b - a for a, b in _union(iv)) / 1e3)
    order = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(
        busy_s=busy, window_s=wall_s, launches=launches, steps=steps,
        device_ops=[[k, v] for k, v in order[:top]],
        idle_gaps=[[k, v] for k, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        kernels=order, placed_by=placed_by,
        ops={n: (statistics.median(t), min(t), max(t))
             for n, t in per_op.items()})


def _host_at(parts, pstarts, cpu, starts, t):
    """'<harness part>/<innermost host op>' running on the host at t (the
    innermost among the 300 host events that started last before t)."""
    j = bisect.bisect_right(pstarts, t) - 1
    part = parts[j][2] if j >= 0 and parts[j][1] >= t else "none"
    i = bisect.bisect_right(starts, t)
    inner, span = "none", None
    for a, b, name in cpu[max(0, i - 300):i]:
        if a <= t <= b and (span is None or b - a < span):
            inner, span = name, b - a
    return f"{part}/{inner}"
