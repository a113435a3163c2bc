"""Kernels: the limit-and-volume stage's share of its bound.  The bytes are
work/limit_volume.py's count from the cell's shapes; the time is the device
time of the port's limit-and-volume entry on the window's last state
(configs/<config>/program.py): the union of its kernels' intervals in
the traced run's profiler trace, each call from a cold L2 on an idle
card, median of 7 (host time and host-device copies inside the call are
not device time).
Share = (bytes / HBM bandwidth) / device time: the stage is bound by
memory traffic, not by arithmetic."""

UNIT = "%"


def read(run):
    ms, nb = run.op_ms("limit_volume"), run.op_bytes("limit_volume")
    if ms is None or nb is None or ms <= 0.0:
        return None
    return 100.0 * (nb / run.peak_bytes_per_s) / (ms * 1e-3)
