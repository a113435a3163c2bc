"""PDF (histogram) estimation from particle ensembles.

The port's own copy of quinoa_tpu/statistics/pdf.py (the reference's
UniPDF/BiPDF/TriPDF estimators, src/Statistics/UniPDF.hpp etc.): a dense
fixed-extent bin array, counted on the particles' device with one
bincount over the flattened bin index.  Extents may be given, like the
reference's user-specified extents, or are taken from the data on the
host.  The bins, extents and counts are the JAX package's for the same
particle array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class UniPDF:
    binsize: float
    lo: float
    counts: np.ndarray  # (nbins,)

    @property
    def nsamples(self) -> int:
        return int(self.counts.sum())

    def density(self) -> np.ndarray:
        return self.counts / (self.nsamples * self.binsize)


@dataclasses.dataclass
class BiPDF:
    binsize: Tuple[float, float]
    lo: Tuple[float, float]
    counts: np.ndarray  # (nx, ny)


@dataclasses.dataclass
class TriPDF:
    binsize: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    counts: np.ndarray  # (nx, ny, nz)


def _bin_index(x, lo, binsize, nbins):
    i = torch.floor((x - lo) / binsize).to(torch.int64)
    return torch.clamp(i, 0, nbins - 1)


def histogram(samples, lo, binsize, nbins):
    """Dense n-D histogram of samples (npar, ndim) with fixed extents, as
    an int32 numpy array of shape nbins."""
    ndim = samples.shape[1]
    idx = torch.zeros(samples.shape[0], dtype=torch.int64,
                      device=samples.device)
    stride = 1
    for d in range(ndim - 1, -1, -1):
        idx = idx + stride * _bin_index(samples[:, d], lo[d], binsize[d],
                                        nbins[d])
        stride *= int(nbins[d])
    flat = torch.bincount(idx, minlength=int(np.prod(nbins)))
    return flat.cpu().numpy().astype(np.int32).reshape(
        tuple(int(n) for n in nbins))


def estimate_pdf(
    particles,
    offsets,
    term,
    binsize: Sequence[float],
    extents: Optional[Sequence[Tuple[float, float]]] = None,
    central: Optional[Sequence[bool]] = None,
):
    """Estimate a 1/2/3-variate PDF of the variables in `term`.

    term : ((depvar, comp), ...) with 1-3 entries.
    binsize : bin width per dimension (like the reference's user request).
    extents : optional (lo, hi) per dimension; taken from the data if
              absent (a host copy of the columns' extremes).
    central : per-dimension flags -- True samples the FLUCTUATION
              value - <value> (central PDF of a lowercase deck variable,
              Statistics::accumulateCenPDF:364-416), False the raw value.
    """
    cols = torch.stack(
        [particles[:, offsets[v[0]] + v[1]] for v in term], dim=1
    )
    if central is not None and any(central):
        mask = torch.tensor([1.0 if c else 0.0 for c in central],
                            dtype=cols.dtype, device=cols.device)
        cols = cols - mask[None, :] * cols.mean(dim=0, keepdim=True)
    ndim = cols.shape[1]
    if ndim not in (1, 2, 3):
        raise ValueError("PDF must be uni/bi/tri-variate")

    if extents is None:
        ext = torch.stack([cols.min(dim=0).values,
                           cols.max(dim=0).values]).cpu().numpy()
        extents = list(zip(ext[0].tolist(), ext[1].tolist()))

    los, nbins = [], []
    for d in range(ndim):
        lo_d, hi_d = extents[d]
        # snap extents to bin boundaries like the reference (bin id = floor)
        lo_d = np.floor(lo_d / binsize[d]) * binsize[d]
        n = max(1, int(np.ceil((hi_d - lo_d) / binsize[d] + 1e-12)) + 1)
        los.append(float(lo_d))
        nbins.append(n)

    counts = histogram(cols, los, list(binsize), nbins)

    if ndim == 1:
        return UniPDF(binsize=binsize[0], lo=los[0], counts=counts)
    if ndim == 2:
        return BiPDF(binsize=tuple(binsize), lo=tuple(los), counts=counts)
    return TriPDF(binsize=tuple(binsize), lo=tuple(los), counts=counts)
