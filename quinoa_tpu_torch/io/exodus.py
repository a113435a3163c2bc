"""ExodusII tetrahedral mesh + field I/O over NetCDF-3 classic.

The port's own copy of quinoa_tpu/io/exodus.py: the same files, byte
for byte.  netCDF-4/HDF5 files go through h5py, imported only when such
a file is opened or written; a classic file never imports it.

Counterpart of the reference's ExodusIIMeshReader/Writer (src/IO/
ExodusIIMesh*.cpp, built on the SEACAS exodus C library).  ExodusII files
are NetCDF-3 classic underneath, which scipy.io.netcdf_file handles
natively — no external library needed.

Reader understands the layouts the reference's committed meshes use:
- TET4 element blocks (tri-shell blocks are collected as boundary faces),
- side sets given either as (tet element, Exodus side) pairs or as
  references to shell-block triangles,
- optional nodal variables + time steps.

Writer emits a single TET4 block, side sets as (element, side) pairs on
the tets, and optional nodal fields per time step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from ..mesh.unsmesh import UnsMesh
from ..mesh.derived import _TET_FACES

# ExodusII TET4 local side -> our face nodes.  Exodus sides (1-based):
# 1:(0,1,3) 2:(1,2,3) 3:(0,3,2) 4:(0,2,1)
_EXO_TET_SIDES = np.array(
    [[0, 1, 3], [1, 2, 3], [0, 3, 2], [0, 2, 1]], dtype=np.int64
)


def _face_key_to_exo_side() -> dict:
    """Map sorted local-node triple -> exodus side number (1-based)."""
    return {tuple(sorted(s)): i + 1 for i, s in enumerate(_EXO_TET_SIDES)}


class _H5NetCDF:
    """Minimal netcdf-4 (HDF5) reader with scipy.io.netcdf_file's shape:
    `.dimensions` (name -> size), `.variables` (name -> sliceable),
    `.close()`.  SEACAS writes netcdf-4 exodus when built with HDF5;
    netCDF-4 stores each dimension as an HDF5 DIMENSION_SCALE dataset
    whose NAME attribute marks pure dimensions."""

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")
        self.dimensions: Dict[str, int] = {}
        self.variables: Dict[str, object] = {}
        for name, ds in self._f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            cls = ds.attrs.get("CLASS", b"")
            if bytes(cls) == b"DIMENSION_SCALE":
                self.dimensions[name] = int(ds.shape[0]) if ds.shape else 0
                nm = bytes(ds.attrs.get("NAME", b""))
                if not nm.startswith(b"This is a netCDF dimension"):
                    # coordinate variable: a dimension AND a variable
                    self.variables[name] = ds
            else:
                self.variables[name] = ds

    def close(self):
        self._f.close()


def _open_exodus(path: str):
    """Open an ExodusII file for reading: NetCDF-3 classic via scipy,
    netcdf-4/HDF5 via h5py (sniffed from the magic bytes)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"\x89HDF":
        return _H5NetCDF(path)
    return netcdf_file(path, "r", mmap=False)


def read_exodus(path: str) -> UnsMesh:
    """Read an ExodusII tet mesh (with side sets) into UnsMesh."""
    f = _open_exodus(path)
    try:
        dims = f.dimensions
        nnode = int(dims["num_nodes"])

        if "coord" in f.variables:
            coords = np.array(f.variables["coord"][:]).T.astype(np.float64)
        else:
            coords = np.stack(
                [
                    np.array(f.variables["coordx"][:]),
                    np.array(f.variables["coordy"][:]),
                    (
                        np.array(f.variables["coordz"][:])
                        if "coordz" in f.variables
                        else np.zeros(nnode)
                    ),
                ],
                axis=1,
            ).astype(np.float64)

        nblk = int(dims.get("num_el_blk", 1))
        blk_ids = (
            np.array(f.variables["eb_prop1"][:]).astype(int)
            if "eb_prop1" in f.variables
            else np.arange(1, nblk + 1)
        )
        tets = []
        tris = []  # shell triangles, if any
        tri_blocks = []  # (block id, tris) for shell blocks
        elem_kind = []  # per global element id: ('tet'|'tri', local index)
        ntet = ntri = 0
        for b in range(1, nblk + 1):
            if f"connect{b}" not in f.variables:
                # declared-but-empty block: files written by other tools
                # (e.g. the reference's meshconv box_24.exo, num_el_blk=3
                # with only connect1/2 present) legally omit the connect
                # variable of a zero-element block
                continue
            conn = f.variables[f"connect{b}"]
            arr = np.array(conn[:]).astype(np.int64) - 1  # to 0-based
            if arr.shape[1] == 4:
                elem_kind += [("tet", ntet + i) for i in range(arr.shape[0])]
                ntet += arr.shape[0]
                tets.append(arr)
            elif arr.shape[1] == 3:
                elem_kind += [("tri", ntri + i) for i in range(arr.shape[0])]
                ntri += arr.shape[0]
                tris.append(arr)
                tri_blocks.append((int(blk_ids[b - 1]), arr))
            else:
                raise ValueError(f"unsupported element block width {arr.shape[1]}")
        inpoel = (
            np.concatenate(tets, axis=0) if tets else np.zeros((0, 4), np.int64)
        )
        tri_all = (
            np.concatenate(tris, axis=0) if tris else np.zeros((0, 3), np.int64)
        )

        mesh = UnsMesh(coords=coords, inpoel=inpoel.astype(np.int32))

        # side sets
        nss = int(dims.get("num_side_sets", 0))
        ss_ids = (
            np.array(f.variables["ss_prop1"][:]).astype(int)
            if "ss_prop1" in f.variables
            else np.arange(1, nss + 1)
        )
        for i in range(1, nss + 1):
            if f"elem_ss{i}" not in f.variables:
                continue
            els = np.array(f.variables[f"elem_ss{i}"][:]).astype(np.int64) - 1
            sides = np.array(f.variables[f"side_ss{i}"][:]).astype(np.int64) - 1
            faces = []
            for e, s in zip(els, sides):
                kind, local = elem_kind[e]
                if kind == "tet":
                    faces.append(inpoel[local][_EXO_TET_SIDES[s]])
                else:  # shell triangle: the face is the triangle itself
                    faces.append(tri_all[local])
            if faces:
                mesh.bface[int(ss_ids[i - 1])] = np.asarray(faces, np.int32)
        if nss == 0:
            # no side sets: shell-triangle blocks ARE the boundary
            # surface (the reference's meshconv meshes, e.g. box_24.exo,
            # carry a TRIANGLES block instead of a side set — its
            # ExodusMeshReader reads them as triinpoel)
            for bid, arr in tri_blocks:
                mesh.bface[bid] = arr.astype(np.int32)
        mesh.bnode = mesh.bnode_from_bface()
        return mesh
    finally:
        f.close()


def read_exodus_fields(path: str):
    """Read nodal variables: (names, times, values (ntime, nvar, nnode))."""
    f = _open_exodus(path)
    try:
        if "name_nod_var" not in f.variables:
            return [], np.zeros(0), np.zeros((0, 0, 0))
        raw = f.variables["name_nod_var"][:]
        names = [
            b"".join(row.tolist()).decode().rstrip("\x00 ").strip()
            for row in raw
        ]
        times = np.array(f.variables["time_whole"][:])
        vals = np.stack(
            [
                np.array(f.variables[f"vals_nod_var{i + 1}"][:])
                for i in range(len(names))
            ],
            axis=1,
        )
        return names, times, vals
    finally:
        f.close()


def read_exodus_elem_fields(path: str):
    """Read element variables of block 1: (names, times, values
    (ntime, nvar, nelem)) — the layout the reference's DG output uses
    (vals_elem_var{i}eb1)."""
    f = _open_exodus(path)
    try:
        if "name_elem_var" not in f.variables:
            return [], np.zeros(0), np.zeros((0, 0, 0))
        raw = f.variables["name_elem_var"][:]
        names = [
            b"".join(row.tolist()).decode().rstrip("\x00 ").strip()
            for row in raw
        ]
        times = np.array(f.variables["time_whole"][:])
        vals = np.stack(
            [
                np.array(f.variables[f"vals_elem_var{i + 1}eb1"][:])
                for i in range(len(names))
            ],
            axis=1,
        )
        return names, times, vals
    finally:
        f.close()


def read_exodus_maps(path: str):
    """Read the (node_num_map, elem_num_map) global-id maps (0-based), or
    (None, None) when the file has no maps (a serial write)."""
    f = _open_exodus(path)
    try:
        nm = (
            np.array(f.variables["node_num_map"][:]).astype(np.int64) - 1
            if "node_num_map" in f.variables else None
        )
        em = (
            np.array(f.variables["elem_num_map"][:]).astype(np.int64) - 1
            if "elem_num_map" in f.variables else None
        )
        return nm, em
    finally:
        f.close()




class _H5Var:
    """Sliceable variable wrapper: extra attribute sets become HDF5
    attrs (scipy's v.name = b"ID" convention)."""

    def __init__(self, ds):
        object.__setattr__(self, "_ds", ds)

    def __setitem__(self, idx, val):
        self._ds[idx] = val

    def __getitem__(self, idx):
        return self._ds[idx]

    def __setattr__(self, k, v):
        self._ds.attrs[k] = v


class _H5NetCDFWriter:
    """scipy.io.netcdf_file-shaped WRITE adapter over h5py producing the
    netCDF-4 layout (dimension-scale datasets + attached scales), the
    format SEACAS emits when built with HDF5.  Covers exactly the calls
    write_exodus makes."""

    def __init__(self, path: str):
        import h5py

        object.__setattr__(self, "_f", h5py.File(path, "w"))
        object.__setattr__(self, "_dims", {})
        object.__setattr__(self, "_h5py", h5py)

    def __setattr__(self, k, v):  # global attributes
        self._f.attrs[k] = v

    def createDimension(self, name, size):
        n = 1 if size is None else int(size)
        ds = self._f.create_dataset(name, data=np.zeros(max(n, 1)))
        ds.attrs["CLASS"] = np.bytes_("DIMENSION_SCALE")
        ds.attrs["NAME"] = np.bytes_(
            "This is a netCDF dimension but not a netCDF variable."
            f"{n:10d}")
        ds.make_scale(name)
        self._dims[name] = (n, size is None, ds)

    def createVariable(self, name, typ, dims):
        dtype = {"d": "f8", "i": "i4", "c": "S1"}[typ]
        shape = tuple(self._dims[d][0] for d in dims)
        maxshape = tuple(
            None if self._dims[d][1] else self._dims[d][0] for d in dims)
        ds = self._f.create_dataset(name, shape=shape, dtype=dtype,
                                    maxshape=maxshape)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._dims[d][2])
        return _H5Var(ds)

    def close(self):
        self._f.close()


def write_exodus(
    path: str,
    mesh: UnsMesh,
    node_fields: Optional[Dict[str, np.ndarray]] = None,
    elem_fields: Optional[Dict[str, np.ndarray]] = None,
    time: float = 0.0,
    title: str = "quinoa_tpu",
    node_num_map: Optional[np.ndarray] = None,
    elem_num_map: Optional[np.ndarray] = None,
    fmt: str = "classic",
) -> None:
    """Write a TET4 ExodusII file with side sets and optional nodal/element
    fields.  node_num_map/elem_num_map (0-based global ids) mark the file
    as a piece of a partitioned mesh (the ExodusII number-map convention
    the joiner in io/pieces.py consumes).  fmt="netcdf4" writes the
    HDF5-based netCDF-4 layout instead of NetCDF-3 classic."""
    f = _H5NetCDFWriter(path) if fmt == "netcdf4" else netcdf_file(path, "w")
    try:
        f.title = title.encode()
        f.api_version = np.float32(5.22)
        f.version = np.float32(5.22)
        f.floating_point_word_size = np.int32(8)
        f.file_size = np.int32(1)

        nnode, nelem = mesh.nnode, mesh.nelem
        # scipy requires the unlimited (record) dimension to come first
        f.createDimension("time_step", None)
        f.createDimension("len_string", 33)
        f.createDimension("len_line", 81)
        f.createDimension("four", 4)
        f.createDimension("len_name", 33)
        f.createDimension("num_dim", 3)
        f.createDimension("num_nodes", nnode)
        f.createDimension("num_elem", nelem)
        f.createDimension("num_el_blk", 1)
        f.createDimension("num_el_in_blk1", nelem)
        f.createDimension("num_nod_per_el1", 4)

        for i, nm in enumerate("xyz"):
            v = f.createVariable(f"coord{nm}", "d", ("num_nodes",))
            v[:] = mesh.coords[:, i]

        eb = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb[:] = np.array([1], dtype=np.int32)
        eb.name = b"ID"
        st = f.createVariable("eb_status", "i", ("num_el_blk",))
        st[:] = np.array([1], dtype=np.int32)

        conn = f.createVariable(
            "connect1", "i", ("num_el_in_blk1", "num_nod_per_el1")
        )
        conn[:] = (mesh.inpoel + 1).astype(np.int32)
        conn.elem_type = b"TET4"

        # side sets: match boundary triangles to (element, exodus side)
        if mesh.bface:
            from ..mesh.derived import gen_esuel

            esuel = gen_esuel(mesh.inpoel, mesh.nnode)
            e_idx, f_idx = np.nonzero(esuel < 0)
            key2ef = {}
            side_of = _face_key_to_exo_side()
            for e, lf in zip(e_idx, f_idx):
                tri = mesh.inpoel[e][_TET_FACES[lf]]
                # find exodus side number whose local nodes match this face
                loc = {
                    int(np.nonzero(mesh.inpoel[e] == n)[0][0]) for n in tri
                }
                key2ef[tuple(sorted(tri.tolist()))] = (
                    e + 1,
                    side_of[tuple(sorted(loc))],
                )
            nss = len(mesh.bface)
            f.createDimension("num_side_sets", nss)
            ssp = f.createVariable("ss_prop1", "i", ("num_side_sets",))
            ssp[:] = np.array(sorted(mesh.bface.keys()), dtype=np.int32)
            ssp.name = b"ID"
            sst = f.createVariable("ss_status", "i", ("num_side_sets",))
            sst[:] = np.ones(nss, dtype=np.int32)
            for i, ss in enumerate(sorted(mesh.bface.keys()), start=1):
                pairs = []
                for tri in mesh.bface[ss]:
                    ef = key2ef.get(tuple(sorted(tri.tolist())))
                    if ef is not None:
                        pairs.append(ef)
                f.createDimension(f"num_side_ss{i}", max(len(pairs), 1))
                ev = f.createVariable(f"elem_ss{i}", "i", (f"num_side_ss{i}",))
                sv = f.createVariable(f"side_ss{i}", "i", (f"num_side_ss{i}",))
                if pairs:
                    ev[:] = np.array([p[0] for p in pairs], dtype=np.int32)
                    sv[:] = np.array([p[1] for p in pairs], dtype=np.int32)
                else:
                    ev[:] = np.array([1], dtype=np.int32)
                    sv[:] = np.array([1], dtype=np.int32)

        tv = f.createVariable("time_whole", "d", ("time_step",))
        tv[0] = time

        if node_fields:
            names = list(node_fields.keys())
            f.createDimension("num_nod_var", len(names))
            nm = f.createVariable(
                "name_nod_var", "c", ("num_nod_var", "len_name")
            )
            arr = np.zeros((len(names), 33), dtype="S1")
            for i, n in enumerate(names):
                for j, ch in enumerate(n.encode()[:32]):
                    arr[i, j] = bytes([ch])
            nm[:] = arr
            for i, n in enumerate(names):
                v = f.createVariable(
                    f"vals_nod_var{i + 1}", "d", ("time_step", "num_nodes")
                )
                v[0, :] = np.asarray(node_fields[n], dtype=np.float64)

        if elem_fields:
            names = list(elem_fields.keys())
            f.createDimension("num_elem_var", len(names))
            nm = f.createVariable(
                "name_elem_var", "c", ("num_elem_var", "len_name")
            )
            arr = np.zeros((len(names), 33), dtype="S1")
            for i, n in enumerate(names):
                for j, ch in enumerate(n.encode()[:32]):
                    arr[i, j] = bytes([ch])
            nm[:] = arr
            for i, n in enumerate(names):
                v = f.createVariable(
                    f"vals_elem_var{i + 1}eb1", "d",
                    ("time_step", "num_el_in_blk1"),
                )
                v[0, :] = np.asarray(elem_fields[n], dtype=np.float64)

        if node_num_map is not None:
            v = f.createVariable("node_num_map", "i", ("num_nodes",))
            v[:] = (np.asarray(node_num_map) + 1).astype(np.int32)
        if elem_num_map is not None:
            v = f.createVariable("elem_num_map", "i", ("num_elem",))
            v[:] = (np.asarray(elem_num_map) + 1).astype(np.int32)
    finally:
        f.close()


def write_exodus_points(path: str, X, Y, Z, name: str, values) -> None:
    """An ExodusII file of points alone (no element block) with one nodal
    field at one time step, 0: the layout the walker's PDF output uses
    for its bin-centre lattices (quinoa_tpu/io/pdfwriter.py
    write_pdf_exodus writes the same file)."""
    f = netcdf_file(path, "w")
    try:
        f.createDimension("time_step", None)
        f.createDimension("num_dim", 3)
        f.createDimension("num_nodes", np.size(X))
        f.createDimension("len_name", 33)
        for nm, vals in (("coordx", X), ("coordy", Y), ("coordz", Z)):
            v = f.createVariable(nm, "d", ("num_nodes",))
            v[:] = np.ravel(vals)
        f.createDimension("num_nod_var", 1)
        nmv = f.createVariable("name_nod_var", "c", ("num_nod_var", "len_name"))
        arr = np.zeros((1, 33), dtype="S1")
        for j, ch in enumerate(name.encode()[:32]):
            arr[0, j] = bytes([ch])
        nmv[:] = arr
        tv = f.createVariable("time_whole", "d", ("time_step",))
        tv[0] = 0.0
        vv = f.createVariable("vals_nod_var1", "d", ("time_step", "num_nodes"))
        vv[0, :] = np.ravel(values)
    finally:
        f.close()
