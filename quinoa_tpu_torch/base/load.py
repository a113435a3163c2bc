"""Load distribution with virtualization (tk::linearLoadDistributor).

The port's own copy of quinoa_tpu/base/load.py (reference
LoadDistributor.cpp:23-90): given the virtualization u in [0, 1], the
total load and the number of processing elements, the chunk size
interpolates between one chunk per processing element (u = 0) and one
unit per item (u = 1),

    chunksize = (1 - u) * load/npe + u * 1,

and the chunk count covers the load.  Under -u the port cuts that many
mesh chunks and packs them onto its shards (parallel/overdecomp.py).
"""

from __future__ import annotations

from typing import Tuple


def linear_load_distributor(
    virtualization: float, load: int, npe: int
) -> Tuple[int, int]:
    """(chunksize, nchare), as the reference computes them; the remainder
    of the load is folded into the last chunk by the caller."""
    if not 0.0 <= virtualization <= 1.0:
        raise ValueError("virtualization must be in [0,1]")
    if load < 1 or npe < 1:
        raise ValueError("positive load and npe required")
    n = load / npe
    chunksize = int((1.0 - virtualization) * n + virtualization * 1.0)
    chunksize = max(chunksize, 1)
    nchare = max(load // chunksize, 1)
    return chunksize, nchare
