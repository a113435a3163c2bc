"""The comparison that decides `correct`.

A gap is taken row by row (one row is one component's one Dubiner mode
over all elements) and measured against the steps' own work: the 2-norm
of the program's row minus the reference's, over the 2-norm of what the
reference's steps changed in that row (its state minus the base state the
steps started from) or, where that is smaller, over the median row's
change, so a row the steps all but leave alone (a transverse momentum, a
trace material's fraction) is held to the scale of the others.  The gap of
two states is the worst row's.  A program that returns its state
unchanged reads 1.  The initial states, which no step has changed yet,
are compared by the largest difference in a row over the reference's
largest magnitude there (or the mean row's, since most rows of a state
at rest are zero).  A non-finite value in the program's state counts as
an error of its row's largest reference magnitude at that element, so a
run that blows up reads a large, finite gap; a non-finite reference
reads NON_FINITE.
"""

from __future__ import annotations

import math

import torch

#: the precision a control computes in, by the configuration's: the
#: nearest below it
LOWER = {"float64": "float32", "float32": "bfloat16"}

#: what a gap reads when either side holds a NaN or an infinity
NON_FINITE = 1.0e300


def _diff(prog, ref):
    """prog - ref, with the row's largest |ref| where prog is not finite;
    None where ref is not finite."""
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    if not bool(torch.isfinite(ref).all()):
        return None
    scale = ref.abs().amax(dim=1, keepdim=True).expand_as(ref)
    return torch.where(torch.isfinite(prog), prog - ref, scale)


def state_gap(prog, ref, base):
    """Worst row gap of prog against ref, the steps from base, all three
    (rows, E)."""
    diff = _diff(prog, ref)
    ref, base = ref.to(torch.float64), base.to(torch.float64)
    if diff is None or not bool(torch.isfinite(base).all()):
        return NON_FINITE
    d = torch.linalg.vector_norm(diff, dim=1)
    n = torch.linalg.vector_norm(ref - base, dim=1)
    den = torch.maximum(n, n.median())
    if float(den.min()) <= 0.0:
        return NON_FINITE if float(d.max()) > 0.0 else 0.0
    return float((d / den).max())


def scale_gap(prog, ref):
    """Worst row of max |prog - ref| over the reference's largest
    magnitude in the row or, where that is smaller, the mean row's."""
    diff = _diff(prog, ref)
    if diff is None:
        return NON_FINITE
    d = diff.abs().amax(dim=1)
    n = ref.to(torch.float64).abs().amax(dim=1)
    den = torch.maximum(n, n.mean())
    if float(den.min()) <= 0.0:
        return NON_FINITE if float(d.max()) > 0.0 else 0.0
    return float((d / den).max())


def mode_rows(nrows, K, modes):
    """The rows (component c, mode k) = c*K + k with k in modes."""
    return [r for r in range(nrows) if r % K in modes]


def rel_gap(prog: float, ref: float):
    """|prog - ref| / |ref| of two scalars (1 for a non-finite prog)."""
    if not math.isfinite(ref) or ref == 0.0:
        return NON_FINITE
    if not math.isfinite(prog):
        return 1.0
    return abs(prog - ref) / abs(ref)


def verdict(numbers, limits):
    """(correct, lines): each number beside its limit, correct when every
    number is at or under its limit and every limit has a number."""
    lines, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and v <= lim
        ok = ok and good
        lines.append(f"check {name} {v!r} limit {lim!r} "
                     f"{'ok' if good else 'FAILED'}")
    return ok, lines
