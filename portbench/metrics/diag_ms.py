"""Diagnostics: mean host milliseconds of one diagnostics call in the
window, diag.compute (inciter/dg.py DGDiagnostics) and its DiagWriter row,
harness clock around both."""

UNIT = "ms"


def read(run):
    if not run.diag_s:
        return None
    return 1e3 * sum(run.diag_s) / len(run.diag_s)
