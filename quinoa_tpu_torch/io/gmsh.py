"""Gmsh 2.2 mesh reader/writer (ASCII and binary).

The port's own copy of quinoa_tpu/io/gmsh.py.

Counterpart of the reference's GmshMeshReader/Writer (src/IO/GmshMesh*.cpp,
msh format 2.2, both file types): $Nodes / $Elements with element type
4 = TET4 and type 2 = TRI3; the first tag (physical group) of a boundary
triangle is its side-set id, matching the reference's meshconv
convention.  Binary layout per the msh 2.2 spec: a 4-byte int 1 after
the format line (endianness probe), node records (int id, 3 doubles),
and element groups headed by (type, count, ntags).
"""

from __future__ import annotations

import struct
from collections import defaultdict

import numpy as np

from ..mesh.unsmesh import UnsMesh

#: nodes per element for the msh element types we care about
_MSH_NNODE = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 15: 1}


def _finish(coords, ids, tets, bface):
    id2idx = {int(g): k for k, g in enumerate(ids)}
    remap = np.vectorize(id2idx.__getitem__, otypes=[np.int64])
    mesh = UnsMesh(
        coords=coords,
        inpoel=(
            remap(np.asarray(tets, dtype=np.int64)).astype(np.int32)
            if len(tets) else np.zeros((0, 4), np.int32)
        ).reshape(-1, 4),
    )
    mesh.bface = {
        ss: remap(np.asarray(v, dtype=np.int64)).astype(np.int32)
        for ss, v in bface.items()
    }
    mesh.bnode = mesh.bnode_from_bface()
    return mesh


def _read_gmsh_binary(buf: bytes) -> UnsMesh:
    def find_after(tag, start=0):
        j = buf.index(tag, start)
        return buf.index(b"\n", j) + 1

    i = find_after(b"$MeshFormat")
    hdr_end = buf.index(b"\n", i)
    one = struct.unpack_from("<i", buf, hdr_end + 1)[0]
    if one != 1:
        raise ValueError("big-endian msh binary not supported")

    i = find_after(b"$Nodes")
    j = buf.index(b"\n", i)
    nnode = int(buf[i:j])
    i = j + 1
    rec = np.dtype([("id", "<i4"), ("xyz", "<f8", (3,))])
    nodes = np.frombuffer(buf, dtype=rec, count=nnode, offset=i)
    i += rec.itemsize * nnode
    coords = nodes["xyz"].astype(np.float64)
    ids = nodes["id"].astype(np.int64)

    i = find_after(b"$Elements", i)
    j = buf.index(b"\n", i)
    nelem = int(buf[i:j])
    i = j + 1
    tets, bface, seen = [], defaultdict(list), 0
    while seen < nelem:
        etype, count, ntags = struct.unpack_from("<3i", buf, i)
        i += 12
        nn = _MSH_NNODE.get(etype)
        if nn is None:
            raise ValueError(f"unsupported msh element type {etype}")
        width = 1 + ntags + nn
        grp = np.frombuffer(buf, dtype="<i4", count=count * width,
                            offset=i).reshape(count, width)
        i += 4 * count * width
        seen += count
        if etype == 4:
            tets.extend(grp[:, 1 + ntags:].tolist())
        elif etype == 2:
            for row in grp:
                ss = int(row[1]) if ntags else 1
                bface[ss].append(row[1 + ntags:].tolist())
    return _finish(coords, ids, tets, bface)


def read_gmsh(path: str) -> UnsMesh:
    with open(path, "rb") as fh:
        buf = fh.read()
    hdr = buf[buf.index(b"$MeshFormat"):][:64].split(b"\n")[1].split()
    if not hdr or not hdr[0].startswith(b"2"):
        raise ValueError(f"unsupported msh version {hdr}: only 2.x")
    if hdr[1] == b"1":
        return _read_gmsh_binary(buf)

    lines = buf.decode().splitlines()
    i = 0

    def until(tag):
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        i += 1

    until("$Nodes")
    nnode = int(lines[i]); i += 1
    ids = np.empty(nnode, dtype=np.int64)
    coords = np.empty((nnode, 3))
    for k in range(nnode):
        parts = lines[i + k].split()
        ids[k] = int(parts[0])
        coords[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
    i += nnode

    until("$Elements")
    nelem = int(lines[i]); i += 1
    tets = []
    bface = defaultdict(list)
    for k in range(nelem):
        parts = lines[i + k].split()
        etype = int(parts[1])
        ntags = int(parts[2])
        tags = [int(x) for x in parts[3 : 3 + ntags]]
        conn = [int(x) for x in parts[3 + ntags :]]
        if etype == 4:
            tets.append(conn)
        elif etype == 2:
            ss = tags[0] if tags else 1
            bface[ss].append(conn)
    return _finish(coords, ids, tets, bface)


def write_gmsh(path: str, mesh: UnsMesh, binary: bool = False) -> None:
    if binary:
        return _write_gmsh_binary(path, mesh)
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n{mesh.nnode}\n")
        for k in range(mesh.nnode):
            x, y, z = mesh.coords[k]
            fh.write(f"{k + 1} {x:.16g} {y:.16g} {z:.16g}\n")
        fh.write("$EndNodes\n")
        ntris = sum(len(v) for v in mesh.bface.values())
        fh.write(f"$Elements\n{mesh.nelem + ntris}\n")
        eid = 1
        for ss in sorted(mesh.bface.keys()):
            for tri in mesh.bface[ss]:
                a, b, c = (int(n) + 1 for n in tri)
                fh.write(f"{eid} 2 2 {ss} {ss} {a} {b} {c}\n")
                eid += 1
        for e in range(mesh.nelem):
            a, b, c, d = (int(n) + 1 for n in mesh.inpoel[e])
            fh.write(f"{eid} 4 2 0 0 {a} {b} {c} {d}\n")
            eid += 1
        fh.write("$EndElements\n")


def _write_gmsh_binary(path: str, mesh: UnsMesh) -> None:
    with open(path, "wb") as fh:
        fh.write(b"$MeshFormat\n2.2 1 8\n")
        fh.write(struct.pack("<i", 1))
        fh.write(b"\n$EndMeshFormat\n")

        fh.write(f"$Nodes\n{mesh.nnode}\n".encode())
        rec = np.empty(mesh.nnode,
                       dtype=np.dtype([("id", "<i4"), ("xyz", "<f8", (3,))]))
        rec["id"] = np.arange(1, mesh.nnode + 1)
        rec["xyz"] = mesh.coords
        fh.write(rec.tobytes())
        fh.write(b"\n$EndNodes\n")

        ntris = sum(len(v) for v in mesh.bface.values())
        fh.write(f"$Elements\n{mesh.nelem + ntris}\n".encode())
        eid = 1
        for ss in sorted(mesh.bface.keys()):
            tris = np.asarray(mesh.bface[ss], dtype=np.int64)
            fh.write(struct.pack("<3i", 2, len(tris), 2))
            grp = np.empty((len(tris), 6), dtype="<i4")
            grp[:, 0] = np.arange(eid, eid + len(tris))
            grp[:, 1] = ss
            grp[:, 2] = ss
            grp[:, 3:] = tris + 1
            fh.write(grp.tobytes())
            eid += len(tris)
        if mesh.nelem:
            fh.write(struct.pack("<3i", 4, mesh.nelem, 2))
            grp = np.empty((mesh.nelem, 7), dtype="<i4")
            grp[:, 0] = np.arange(eid, eid + mesh.nelem)
            grp[:, 1] = 0
            grp[:, 2] = 0
            grp[:, 3:] = mesh.inpoel.astype(np.int64) + 1
            fh.write(grp.tobytes())
        fh.write(b"\n$EndElements\n")
