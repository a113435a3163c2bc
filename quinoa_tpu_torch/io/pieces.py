"""Partitioned (per-chunk) ExodusII field output and its joiner.

The port's own copy of quinoa_tpu/io/pieces.py, the counterpart of the
reference's MeshWriter chare group (src/IO/MeshWriter.cpp), which writes
one ExodusII piece per chare named `<base>.e-s.<t>.<nchunk>.<chunk>`.
The pieces also carry the ExodusII node_num_map/elem_num_map global-id
maps, so join_exodus_pieces reassembles them into the global mesh and
fields (meshconv with several inputs).  Host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..mesh.unsmesh import UnsMesh
from .exodus import (
    read_exodus,
    read_exodus_elem_fields,
    read_exodus_fields,
    read_exodus_maps,
    write_exodus,
)


def extract_piece(mesh: UnsMesh, parts: np.ndarray, p: int):
    """Local mesh of partition p plus its 0-based global-id maps.

    parts : (nelem,) partition id per element.
    Returns (local mesh, node_num_map, elem_num_map).  Side-set triangles
    are inherited from the global mesh; each boundary triangle lands in
    exactly the piece owning its element (write_exodus drops triangles
    whose element is not a local boundary face).
    """
    eids = np.nonzero(np.asarray(parts) == p)[0]
    cells = mesh.inpoel[eids]
    nids, local = np.unique(cells, return_inverse=True)
    g2l = {int(g): i for i, g in enumerate(nids)}
    lm = UnsMesh(
        coords=mesh.coords[nids],
        inpoel=local.reshape(cells.shape).astype(np.int32),
    )
    nset = set(nids.tolist())
    for ss, tris in mesh.bface.items():
        keep = [t for t in tris.tolist() if all(n in nset for n in t)]
        if keep:
            lm.bface[ss] = np.asarray(
                [[g2l[n] for n in t] for t in keep], np.int32
            )
    lm.bnode = lm.bnode_from_bface()
    return lm, nids.astype(np.int64), eids.astype(np.int64)


def piece_path(base: str, it: int, npart: int, p: int) -> str:
    """The reference's piece naming: <base>.e-s.<t>.<nchunk>.<chunk>
    (MeshWriter.cpp filename())."""
    return f"{base}.e-s.{it}.{npart}.{p}"


def write_exodus_pieces(
    base: str,
    mesh: UnsMesh,
    parts: np.ndarray,
    node_fields: Optional[Dict[str, np.ndarray]] = None,
    elem_fields: Optional[Dict[str, np.ndarray]] = None,
    time: float = 0.0,
    it: int = 0,
) -> List[str]:
    """Write one ExodusII piece per partition; returns the file paths."""
    parts = np.asarray(parts)
    npart = int(parts.max()) + 1 if len(parts) else 1
    paths = []
    for p in range(npart):
        lm, nmap, emap = extract_piece(mesh, parts, p)
        nf = {k: np.asarray(v)[nmap] for k, v in (node_fields or {}).items()}
        ef = {k: np.asarray(v)[emap] for k, v in (elem_fields or {}).items()}
        path = piece_path(base, it, npart, p)
        write_exodus(path, lm, node_fields=nf or None, elem_fields=ef or None,
                     time=time, node_num_map=nmap, elem_num_map=emap)
        paths.append(path)
    return paths


def join_exodus_pieces(paths: Sequence[str]):
    """Reassemble pieces into (mesh, node_fields, elem_fields, time).

    Fields come back in GLOBAL numbering via the pieces' number maps;
    shared (halo) nodes are written identically by every owning piece, so
    last-writer-wins assembly is exact.
    """
    metas = []
    nnode = nelem = 0
    for path in paths:
        m = read_exodus(path)
        nmap, emap = read_exodus_maps(path)
        if nmap is None or emap is None:
            raise ValueError(f"{path} has no number maps; not a piece")
        metas.append((m, nmap, emap))
        nnode = max(nnode, int(nmap.max()) + 1)
        nelem = max(nelem, int(emap.max()) + 1)

    coords = np.zeros((nnode, 3))
    inpoel = np.zeros((nelem, 4), np.int32)
    bface: Dict[int, list] = {}
    for m, nmap, emap in metas:
        coords[nmap] = m.coords
        inpoel[emap] = nmap[m.inpoel].astype(np.int32)
        for ss, tris in m.bface.items():
            bface.setdefault(ss, []).extend(nmap[tris].tolist())
    mesh = UnsMesh(coords=coords, inpoel=inpoel)
    for ss, tris in bface.items():
        mesh.bface[ss] = np.asarray(tris, np.int32)
    mesh.bnode = mesh.bnode_from_bface()

    node_fields: Dict[str, np.ndarray] = {}
    elem_fields: Dict[str, np.ndarray] = {}
    time = 0.0
    for path, (m, nmap, emap) in zip(paths, metas):
        names, times, vals = read_exodus_fields(path)
        for i, n in enumerate(names):
            node_fields.setdefault(n, np.zeros(nnode))[nmap] = vals[-1, i]
        names, times, vals = read_exodus_elem_fields(path)
        for i, n in enumerate(names):
            elem_fields.setdefault(n, np.zeros(nelem))[emap] = vals[-1, i]
        if len(times):
            time = float(times[-1])
    return mesh, node_fields, elem_fields, time
