"""HyperMesh reader.

The port's own copy of quinoa_tpu/io/hypermesh.py.

Counterpart of the reference's HyperMeshReader (src/IO/HyperMeshReader.cpp):
an XML metadata file whose <mesh> children name two sidecar text files —
<coordinates file="..."/> with `id x y z` lines (ids assumed in order)
and <element_set file="..." topology="four_node_tet"/> with
`id n1 n2 n3 n4` lines.  Node ids in the connectivity are whatever the
generator wrote; like the reference (which relies on shiftToZero), they
are normalized to 0-based here.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..mesh.unsmesh import UnsMesh


def read_hypermesh(path: str) -> UnsMesh:
    meta = ET.parse(path).getroot()
    root = meta if meta.tag == "mesh" else meta.find("mesh")
    if root is None:
        raise ValueError(f"{path}: no <mesh> element in HyperMesh metadata")
    base = os.path.dirname(path)
    coordfile = elemfile = None
    for group in root:
        if group.tag == "coordinates":
            coordfile = os.path.join(base, group.attrib["file"])
        elif group.tag == "element_set":
            topo = group.attrib.get("topology", "four_node_tet")
            if topo != "four_node_tet":
                raise ValueError(
                    "only pure tetrahedron HyperMesh element sets are "
                    f"supported, got topology {topo!r}")
            elemfile = os.path.join(base, group.attrib["file"])
    if coordfile is None or elemfile is None:
        raise ValueError(f"{path}: metadata lacks coordinates/element_set")

    coords = np.loadtxt(coordfile, ndmin=2)[:, 1:4]
    conn = np.loadtxt(elemfile, dtype=np.int64, ndmin=2)[:, 1:5]
    conn -= conn.min()  # shiftToZero: normalize whatever base the ids use
    coords = coords.astype(np.float64)
    conn = conn.astype(np.int64)
    # fix inverted tets (swap last two nodes), as the other text readers do
    a, b, c, d = (coords[conn[:, i]] for i in range(4))
    j = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    flip = j < 0
    conn[flip, 2], conn[flip, 3] = conn[flip, 3].copy(), conn[flip, 2].copy()
    return UnsMesh(coords=coords, inpoel=conn.astype(np.int32))
