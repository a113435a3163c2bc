"""Problem policies: initial and analytic solutions."""

from .compflow import (NLEnergyGrowth, RayleighTaylor, RotatedSodShocktube,
                       SedovBlastwave, SodShocktube, TaylorGreen, UserDefined,
                       VorticalFlow)
from .multimat import MMInterfaceAdvection, MMSmoothWave, MMSodShocktube
from .transport import CylAdvect, GaussHump, ShearDiff, SlotCyl

__all__ = ["CylAdvect", "GaussHump", "MMInterfaceAdvection", "MMSmoothWave",
           "MMSodShocktube", "NLEnergyGrowth", "RayleighTaylor",
           "RotatedSodShocktube", "SedovBlastwave", "ShearDiff", "SlotCyl",
           "SodShocktube", "TaylorGreen", "UserDefined", "VorticalFlow"]
