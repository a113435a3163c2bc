"""Control layer: the `.q` control-file DSL and the typed inciter
configuration.

The port's own copy of quinoa_tpu/control's inciter part (the reference's
src/Control/): the deck schema is the contract, so the same
block-structured keyword files drive both packages.
"""

from .config import (InciterConfig, apply_t0ref, build_inciter,
                     load_inciter)
from .qparser import first, occurrences, parse_deck

__all__ = ["InciterConfig", "apply_t0ref", "build_inciter", "first",
           "load_inciter", "occurrences", "parse_deck"]
