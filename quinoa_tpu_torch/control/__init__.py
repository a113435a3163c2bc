"""Control layer: the `.q` control-file DSL and the typed inciter and
walker configurations.

The port's own copy of quinoa_tpu/control's inciter and walker parts (the
reference's src/Control/): the deck schema is the contract, so the same
block-structured keyword files drive both packages.
"""

from .config import (InciterConfig, WalkerConfig, apply_t0ref,
                     build_inciter, build_walker, load_inciter, load_walker)
from .qparser import first, occurrences, parse_deck

__all__ = ["InciterConfig", "WalkerConfig", "apply_t0ref", "build_inciter",
           "build_walker", "first", "load_inciter", "load_walker",
           "occurrences", "parse_deck"]
