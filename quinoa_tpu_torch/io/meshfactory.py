"""Mesh format detection and conversion.

The port's own copy of quinoa_tpu/io/meshfactory.py.

Counterpart of the reference's MeshFactory + MeshDetect (src/IO/
MeshFactory.cpp, MeshDetect.cpp) driving the meshconv executable
(src/Main/MeshConvDriver.cpp:46-65): detect the input format from content,
read into UnsMesh, write in the format implied by the output extension.
"""

from __future__ import annotations

import os

from .exodus import read_exodus, write_exodus
from .gmsh import read_gmsh, write_gmsh
from .netgen import read_netgen, write_netgen
from .asc import read_asc
from .hypermesh import read_hypermesh


def detect_format(path: str) -> str:
    """Detect a mesh file's format from magic bytes / structure."""
    import os

    if path.endswith(".osh") or os.path.isdir(path):
        # the reference gates its Omega_h reader behind ENABLE_OMEGA_H
        # (the library is not in this image either)
        raise ValueError(
            "Omega_h (.osh) meshes are not supported in this build "
            "(no Omega_h library); convert to ExodusII or Gmsh first"
        )
    with open(path, "rb") as fh:
        head = fh.read(16)
    if head.startswith(b"CDF") or head.startswith(b"\x89HDF"):
        # NetCDF-3 classic or netcdf-4/HDF5 exodus (both handled by
        # io/exodus.py's _open_exodus dispatcher)
        return "exodus"
    try:
        text = head.decode("ascii", errors="strict")
    except UnicodeDecodeError:
        raise ValueError(f"unrecognized (binary, non-NetCDF) mesh: {path}")
    if text.lstrip().startswith("$MeshFormat"):
        return "gmsh"
    if text.lstrip().startswith("*ndim"):
        return "asc"
    if text.lstrip().startswith("<"):
        return "hypermesh"
    # Netgen neutral starts with an integer count on its own line
    first = text.split()[0] if text.split() else ""
    if first.isdigit():
        return "netgen"
    raise ValueError(f"cannot detect mesh format of {path}")


_READERS = {"exodus": read_exodus, "gmsh": read_gmsh, "netgen": read_netgen, "asc": read_asc, "hypermesh": read_hypermesh}
_WRITERS = {"exodus": write_exodus, "gmsh": write_gmsh, "netgen": write_netgen}

_EXT2FMT = {
    ".exo": "exodus",
    ".e": "exodus",
    ".g": "exodus",
    ".msh": "gmsh",
    ".asc": "asc",
    ".xml": "hypermesh",
    ".mesh": "netgen",
    ".neu": "netgen",
}


def format_from_extension(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _EXT2FMT:
        raise ValueError(f"cannot infer mesh format from extension {ext!r}")
    return _EXT2FMT[ext]


def read_mesh(path: str, fmt: str | None = None):
    fmt = fmt or detect_format(path)
    return _READERS[fmt](path)


def write_mesh(path: str, mesh, fmt: str | None = None) -> None:
    fmt = fmt or format_from_extension(path)
    _WRITERS[fmt](path, mesh)
