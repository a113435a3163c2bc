"""Diagnostics text-file writer.

The port's own copy of quinoa_tpu/io/diagwriter.py: the same rows give
the same bytes.

Counterpart of the reference's DiagWriter (src/IO/DiagWriter.cpp) +
Transporter::diagHeader (src/Inciter/Transporter.cpp:641-683): a
column-oriented text table with one header line and one row per
diagnostics interval — the primary regression-test observable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..base.profiler import span


class DiagWriter:
    def __init__(self, path: str, ncomp: int,
                 labels: Optional[Sequence[str]] = None,
                 fmt: str = "scientific", precision: int = 12):
        self.path = path
        self.ncomp = ncomp
        # TxtFloatFormat (diagnostics block format/precision keywords,
        # DiagWriter.cpp analog); scientific/12 is the historic default
        if fmt == "fixed":
            self._f = lambda x: f"{x:.{precision}f}"
        elif fmt == "default":
            self._f = lambda x: f"{x:.{precision}g}"
        else:
            self._f = lambda x: f"{x:.{precision}e}"
        cols = ["it", "t", "dt"]
        lab = labels or [f"u{c}" for c in range(ncomp)]
        cols += [f"L2({v})" for v in lab]
        cols += [f"L2(err:{v})" for v in lab]
        cols += [f"Linf(err:{v})" for v in lab]
        self._fh = open(path, "w")
        self._fh.write("# " + "\t".join(f"{i + 1}:{c}" for i, c in enumerate(cols)) + "\n")

    def write(self, it: int, t: float, dt: float, l2sol, l2err=None, linferr=None):
        with span("diag.write"):
            F = self._f
            row: List[str] = [str(it), F(t), F(dt)]
            row += [F(v) for v in l2sol]
            row += [F(v) for v in (l2err if l2err is not None else [])]
            row += [F(v) for v in (linferr if linferr is not None else [])]
            self._fh.write("\t".join(row) + "\n")
            self._fh.flush()

    def close(self):
        self._fh.close()
