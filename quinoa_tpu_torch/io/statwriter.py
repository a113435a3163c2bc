"""walker statistics text writer.

The port's own copy of quinoa_tpu/io/statwriter.py (the reference's
TxtStatWriter, src/IO/TxtStatWriter.cpp): time series of the requested
ordinary and central moments, in the same columns and number format.
"""

from __future__ import annotations

from typing import Sequence


def _term_label(term) -> str:
    if term and term[0] == "C":
        return "<" + "".join(f"{v[0].lower()}{v[1] + 1}" for v in term[1:]) + ">"
    return "<" + "".join(f"{v[0].upper()}{v[1] + 1}" for v in term) + ">"


class TxtStatWriter:
    def __init__(self, path: str, ordinary: Sequence = (),
                 central: Sequence = (), fmt: str = "scientific",
                 precision: int = 12):
        self.path = path
        self.terms = list(ordinary) + [("C",) + t for t in central]
        # TxtFloatFormat (statistics block format/precision keywords,
        # TxtStatWriter.cpp); scientific/12 is the historic default
        if fmt == "fixed":
            self._f = lambda x: f"{x:.{precision}f}"
        elif fmt == "default":
            self._f = lambda x: f"{x:.{precision}g}"
        else:
            self._f = lambda x: f"{x:.{precision}e}"
        self._fh = open(path, "w")
        cols = ["it", "t"] + [_term_label(t) for t in self.terms]
        self._fh.write(
            "# " + "\t".join(f"{i + 1}:{c}" for i, c in enumerate(cols)) + "\n"
        )

    def write(self, it: int, t: float, moments: dict):
        """One row: it, t and the moments ({term: float}) in column order."""
        F = self._f
        row = [str(it), F(t)]
        row += [F(moments[k]) for k in self.terms]
        self._fh.write("\t".join(row) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
