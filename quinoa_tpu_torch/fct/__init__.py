"""Flux-corrected transport of the DiagCG scheme."""

from .fct import FCT

__all__ = ["FCT"]
