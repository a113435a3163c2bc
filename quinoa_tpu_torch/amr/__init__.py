"""h-adaptive mesh refinement on the host (numpy).

The port's own copy of quinoa_tpu/amr (the reference's AMR kernel,
src/Inciter/AMR/, and the Refiner chare, src/Inciter/Refiner.cpp):
edge-tag -> compatibility closure -> template subdivision -> solution
transfer, as vectorized host-side (re)mesh events.  A refinement event
rebuilds the solver's device tables on the new mesh (cli.py).

Derefinement (derefine_mesh) collapses fully-flagged sibling groups back
to their parent, subject to conformity locks iterated to a fixed point,
with exactly conservative DG transfer and subset CG transfer.  The
multi-pass intermediates machine (multipass.py) and the incremental
multi-level dtref cycle (adapt.py) sit on top.
"""

from .refine import (
    compatible_tags, refine_mesh, uniform_refine, RefineMap,
    derefine_mesh, transfer_cg_derefine, transfer_dg_derefine,
)
from .error import edge_errors, tag_edges_by_error, tag_edges_by_coords

__all__ = [
    "compatible_tags",
    "refine_mesh",
    "uniform_refine",
    "RefineMap",
    "derefine_mesh",
    "transfer_cg_derefine",
    "transfer_dg_derefine",
    "edge_errors",
    "tag_edges_by_error",
    "tag_edges_by_coords",
]
