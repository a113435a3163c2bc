"""Problem policies: initial and analytic solutions."""

from .compflow import SedovBlastwave, TaylorGreen, VorticalFlow
from .transport import GaussHump, SlotCyl

__all__ = ["GaussHump", "SedovBlastwave", "SlotCyl", "TaylorGreen",
           "VorticalFlow"]
