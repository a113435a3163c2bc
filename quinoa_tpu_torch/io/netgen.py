"""Netgen neutral-format mesh reader/writer.

The port's own copy of quinoa_tpu/io/netgen.py.

Counterpart of the reference's NetgenMeshReader/Writer (src/IO/
NetgenMesh*.cpp).  Neutral format:

    npoints
    x y z            (1-based node ids implicit)
    ntets
    matnr n1 n2 n3 n4
    ntris
    surfnr n1 n2 n3

surfnr is used as the side-set id (like the reference's meshconv).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..mesh.unsmesh import UnsMesh


def read_netgen(path: str) -> UnsMesh:
    with open(path) as fh:
        tokens = fh.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos : pos + n]
        pos += n
        return out

    npoin = int(take(1)[0])
    coords = np.array(take(3 * npoin), dtype=np.float64).reshape(npoin, 3)
    ntet = int(take(1)[0])
    tets = np.array(take(5 * ntet), dtype=np.int64).reshape(ntet, 5)
    # the netgen neutral file carries tets ROTATED: the line is
    # (tag, n3, n0, n1, n2) — NetgenMeshReader.cpp:86 reads
    # tag >> n[3] >> n[0] >> n[1] >> n[2]
    inpoel = tets[:, [2, 3, 4, 1]] - 1
    # safeguard: fix any negatively-oriented tets (files from other
    # tools), matching build_dggeom's positive-Jacobian requirement
    mesh = UnsMesh(coords=coords, inpoel=inpoel.astype(np.int32))
    x = mesh.coords
    a, b, c, d = (x[mesh.inpoel[:, i]] for i in range(4))
    j = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    flip = j < 0
    if flip.any():
        inp = mesh.inpoel.copy()
        inp[flip, 2], inp[flip, 3] = mesh.inpoel[flip, 3], mesh.inpoel[flip, 2]
        mesh.inpoel = inp

    bface = defaultdict(list)
    if pos < len(tokens):
        ntri = int(take(1)[0])
        for _ in range(ntri):
            surf, n1, n2, n3 = (int(v) for v in take(4))
            bface[surf].append([n1 - 1, n2 - 1, n3 - 1])
    mesh.bface = {ss: np.asarray(v, dtype=np.int32) for ss, v in bface.items()}
    mesh.bnode = mesh.bnode_from_bface()
    return mesh


def write_netgen(path: str, mesh: UnsMesh) -> None:
    with open(path, "w") as fh:
        fh.write(f"{mesh.nnode}\n")
        for k in range(mesh.nnode):
            x, y, z = mesh.coords[k]
            fh.write(f" {x:.16g} {y:.16g} {z:.16g}\n")
        fh.write(f"{mesh.nelem}\n")
        for e in range(mesh.nelem):
            a, b, c, d = (int(n) + 1 for n in mesh.inpoel[e])
            # rotated on disk: (tag, n3, n0, n1, n2) —
            # NetgenMeshWriter.cpp:86-90
            fh.write(f" 1 {d} {a} {b} {c}\n")
        ntris = sum(len(v) for v in mesh.bface.values())
        fh.write(f"{ntris}\n")
        for ss in sorted(mesh.bface.keys()):
            for tri in mesh.bface[ss]:
                a, b, c = (int(n) + 1 for n in tri)
                fh.write(f" {ss} {a} {b} {c}\n")
