"""Kernels: the p-adaptive limit pass's share of its bound.  The bytes are
work/pref_limit.py's count from the cell's shapes; the time is the device
time of the port's p-adaptive limit entries on the window's last state
(configs/<config>/program.py: indicator, ring promotion, dofmask, K4
bounds, Superbee with the dofmask, zeroing): the union of their kernels'
intervals in the traced run's profiler trace, each call from a cold L2
on an idle card, median of 7 (host time inside the call is not device
time).
Share = (bytes / HBM bandwidth) / device time: the pass is bound by
memory traffic, not by arithmetic."""

UNIT = "%"


def read(run):
    ms, nb = run.op_ms("pref_limit"), run.op_bytes("pref_limit")
    if ms is None or nb is None or ms <= 0.0:
        return None
    return 100.0 * (nb / run.peak_bytes_per_s) / (ms * 1e-3)
