"""ASCII STL surface-mesh reader (the port's own copy of quinoa_tpu/io/
stl.py, the reference's src/IO/STLTxtMeshReader.cpp).

STL carries a triangle soup; like the reference's STLMesh this returns
the surface (coordinates and triangles over welded vertices) as geometry
input, not a volume mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class STLMesh:
    coords: np.ndarray  # (nnode, 3)
    tri: np.ndarray  # (ntri, 3)


def read_stl(path: str, weld_tol: float = 0.0) -> STLMesh:
    """The triangles of an ASCII STL file over its distinct vertices
    (equal after rounding to 12 decimals if weld_tol is set)."""
    verts = []
    with open(path) as fh:
        first = fh.readline()
        if not first.lower().startswith("solid"):
            raise ValueError("only ASCII STL supported (missing 'solid')")
        for line in fh:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    v = np.asarray(verts)
    if len(v) % 3:
        raise ValueError("STL vertex count not a multiple of 3")
    uniq, inv = np.unique(v.round(12) if weld_tol else v, axis=0,
                          return_inverse=True)
    tri = inv.reshape(-1, 3).astype(np.int32)
    return STLMesh(coords=uniq, tri=tri)
