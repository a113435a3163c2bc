"""Mesh and field I/O.

The port's own copy of the part of quinoa_tpu/io the inciter command
opens (the reference's src/IO/): ExodusII (NetCDF-3 classic through
scipy.io.netcdf_file; netCDF-4/HDF5 through h5py, imported only for such
a file), Gmsh 2.2 (ASCII and binary), Netgen neutral, ASC and HyperMesh
readers, format detection, the diagnostics writer, and the walker's
statistics and PDF writers.  The files are those of the JAX package, so
either package reads what the other wrote.
"""

from .asc import read_asc
from .diagwriter import DiagWriter
from .exodus import (read_exodus, read_exodus_elem_fields,
                     read_exodus_fields, read_exodus_maps, write_exodus,
                     write_exodus_points)
from .gmsh import read_gmsh, write_gmsh
from .hypermesh import read_hypermesh
from .meshfactory import (detect_format, format_from_extension, read_mesh,
                          write_mesh)
from .netgen import read_netgen, write_netgen
from .pdfwriter import write_pdf_exodus, write_pdf_gmsh, write_pdf_txt
from .statwriter import TxtStatWriter

__all__ = [
    "DiagWriter",
    "TxtStatWriter",
    "detect_format",
    "format_from_extension",
    "read_asc",
    "read_exodus",
    "read_exodus_elem_fields",
    "read_exodus_fields",
    "read_exodus_maps",
    "read_gmsh",
    "read_hypermesh",
    "read_mesh",
    "read_netgen",
    "write_exodus",
    "write_exodus_points",
    "write_gmsh",
    "write_mesh",
    "write_netgen",
    "write_pdf_exodus",
    "write_pdf_gmsh",
    "write_pdf_txt",
]
