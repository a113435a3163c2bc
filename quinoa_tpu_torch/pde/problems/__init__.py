"""Problem policies: initial and analytic solutions."""

from .compflow import SedovBlastwave

__all__ = ["SedovBlastwave"]
