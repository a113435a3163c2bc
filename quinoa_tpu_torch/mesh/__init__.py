"""Meshes on the host (numpy): the container, the box-mesh generator,
derived connectivity, element geometry, the mesh statistics, and the
Hilbert element, first-touch node and Morton reorders (the exports of
quinoa_tpu.mesh and the port's reorders)."""

from .boxmesh import box_tet_mesh
from .derived import (gen_edsup, gen_esuel, gen_esup, gen_faces, gen_inpoed,
                      gen_psup)
from .geometry import node_gradients, nodal_volumes, tet_geometry
from .reorder import (first_touch_node_reorder, hilbert_codes,
                      hilbert_element_reorder, sfc_reorder)
from .unsmesh import UnsMesh

__all__ = ["UnsMesh", "box_tet_mesh", "first_touch_node_reorder",
           "gen_edsup", "gen_esuel", "gen_esup", "gen_faces", "gen_inpoed",
           "gen_psup", "hilbert_codes", "hilbert_element_reorder",
           "nodal_volumes", "node_gradients", "sfc_reorder", "tet_geometry"]
