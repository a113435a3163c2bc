"""Meshes: the jax-free box-mesh generator of quinoa_tpu.mesh.boxmesh,
shared by import, and the port's Hilbert element reorder."""

from quinoa_tpu.mesh.boxmesh import box_tet_mesh

from .reorder import hilbert_codes, hilbert_element_reorder

__all__ = ["box_tet_mesh", "hilbert_codes", "hilbert_element_reorder"]
