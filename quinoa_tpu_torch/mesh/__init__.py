"""Meshes: the jax-free box-mesh generator of quinoa_tpu.mesh.boxmesh,
shared by import, and the port's Hilbert element and first-touch node
reorders."""

from quinoa_tpu.mesh.boxmesh import box_tet_mesh

from .reorder import (first_touch_node_reorder, hilbert_codes,
                      hilbert_element_reorder)

__all__ = ["box_tet_mesh", "first_touch_node_reorder", "hilbert_codes",
           "hilbert_element_reorder"]
