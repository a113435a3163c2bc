"""Moments and PDFs of particle ensembles (the port's own copy of
quinoa_tpu/statistics; the reference's src/Statistics/)."""

from .stats import (
    Term,
    mean,
    variance,
    ordinary_moment,
    central_moment,
    estimate_moments,
    moments_to_host,
)
from .pdf import UniPDF, BiPDF, TriPDF, estimate_pdf

__all__ = [
    "Term",
    "mean",
    "variance",
    "ordinary_moment",
    "central_moment",
    "estimate_moments",
    "moments_to_host",
    "UniPDF",
    "BiPDF",
    "TriPDF",
    "estimate_pdf",
]
