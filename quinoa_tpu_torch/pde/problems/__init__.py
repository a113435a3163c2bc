"""Problem policies: initial and analytic solutions."""

from .compflow import SedovBlastwave, SodShocktube, TaylorGreen, VorticalFlow
from .multimat import MMInterfaceAdvection, MMSmoothWave, MMSodShocktube
from .transport import GaussHump, SlotCyl

__all__ = ["GaussHump", "MMInterfaceAdvection", "MMSmoothWave",
           "MMSodShocktube", "SedovBlastwave", "SlotCyl", "SodShocktube",
           "TaylorGreen", "VorticalFlow"]
