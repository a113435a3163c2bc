"""Unstructured tetrahedral mesh container (host side, numpy).

The port's own copy of quinoa_tpu/mesh/unsmesh.py (reference
tk::UnsMesh, src/Mesh/UnsMesh.hpp:50-119): the kernels never see this
class, they consume the dense tables the geometry builders derive from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class UnsMesh:
    """3-D unstructured tetrahedral mesh.

    coords : (nnode, 3) float64  node coordinates
    inpoel : (nelem, 4) int32    tetrahedron connectivity (zero-based)
    bface  : side-set id -> (nbf, 3) int32 boundary triangles
    bnode  : side-set id -> (nbn,) int32 boundary node ids
    """

    coords: np.ndarray
    inpoel: np.ndarray
    bface: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    bnode: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.inpoel = np.ascontiguousarray(self.inpoel, dtype=np.int32)
        if self.coords.ndim != 2 or self.coords.shape[1] != 3:
            raise ValueError(f"coords must be (nnode,3), got "
                             f"{self.coords.shape}")
        if self.inpoel.ndim != 2 or self.inpoel.shape[1] != 4:
            raise ValueError(f"inpoel must be (nelem,4), got "
                             f"{self.inpoel.shape}")

    @property
    def nnode(self) -> int:
        return self.coords.shape[0]

    @property
    def nelem(self) -> int:
        return self.inpoel.shape[0]

    def bnode_from_bface(self) -> Dict[int, np.ndarray]:
        """Per-side-set unique node lists from the boundary triangles."""
        return {ss: np.unique(tris.ravel()).astype(np.int32)
                for ss, tris in self.bface.items()}

    def all_bnodes(self) -> np.ndarray:
        """Unique node ids over all side sets."""
        if not self.bnode and self.bface:
            self.bnode = self.bnode_from_bface()
        if not self.bnode:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(list(self.bnode.values())))
