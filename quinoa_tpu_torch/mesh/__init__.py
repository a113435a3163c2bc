"""Meshes on the host (numpy): the container, the box-mesh generator,
derived connectivity, element geometry, and the Hilbert element and
first-touch node reorders."""

from .boxmesh import box_tet_mesh
from .reorder import (first_touch_node_reorder, hilbert_codes,
                      hilbert_element_reorder)
from .unsmesh import UnsMesh

__all__ = ["UnsMesh", "box_tet_mesh", "first_touch_node_reorder",
           "hilbert_codes", "hilbert_element_reorder"]
