"""Problem policies: initial and analytic solutions."""

from .compflow import SedovBlastwave
from .transport import GaussHump

__all__ = ["GaussHump", "SedovBlastwave"]
