"""ASC tet-mesh reader (src/IO/ASCMeshReader.cpp format).

The port's own copy of quinoa_tpu/io/asc.py.

Format:
    *ndim 3
    *numNodeSets n
    *numSideSets n
    *nodes N
      id x y z              (ids assumed sorted)
    *cells E
      id a b n3 n0 n1 n2    (nodes 2/3 swapped for positive volume,
                             ids shifted to zero, per the reference)
"""

from __future__ import annotations

import numpy as np

from ..mesh.unsmesh import UnsMesh


def read_asc(path: str) -> UnsMesh:
    toks = open(path).read().split()
    pos = 0

    def expect(kw):
        nonlocal pos
        if toks[pos] != kw:
            raise ValueError(f"ASC: expected {kw!r}, got {toks[pos]!r}")
        pos += 1

    def take_int():
        nonlocal pos
        v = int(toks[pos])
        pos += 1
        return v

    expect("*ndim")
    if take_int() != 3:
        raise ValueError("only 3D ASC meshes supported")
    expect("*numNodeSets")
    take_int()
    expect("*numSideSets")
    take_int()

    expect("*nodes")
    nnode = take_int()
    coords = np.empty((nnode, 3))
    for i in range(nnode):
        pos += 1  # node id (assumed sorted)
        coords[i] = [float(toks[pos]), float(toks[pos + 1]),
                     float(toks[pos + 2])]
        pos += 3

    expect("*cells")
    nel = take_int()
    inpoel = np.empty((nel, 4), dtype=np.int64)
    for e in range(nel):
        # id, a, b (ignored), then n3 n0 n1 n2
        n3 = int(toks[pos + 3])
        n0 = int(toks[pos + 4])
        n1 = int(toks[pos + 5])
        n2 = int(toks[pos + 6])
        # switch nodes 2 and 3 for positive volume (reference convention)
        inpoel[e] = [n0, n1, n3, n2]
        pos += 7

    inpoel = inpoel - inpoel.min()  # tk::shiftToZero
    return UnsMesh(coords=coords, inpoel=inpoel.astype(np.int32))
