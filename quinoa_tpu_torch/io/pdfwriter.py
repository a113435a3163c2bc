"""PDF output: txt, Gmsh, and ExodusII formats.

The port's own copy of quinoa_tpu/io/pdfwriter.py (the reference's
PDFWriter, src/IO/PDFWriter.cpp): txt writes bin centers + density;
gmsh writes bi-variate PDFs as structured quad meshes with the density as
element or node data; exodus writes the bin-centre lattice as points
with a nodal density (io.exodus.write_exodus_points).  The files are the
JAX package's for the same PDF.
"""

from __future__ import annotations

import numpy as np

from .exodus import write_exodus_points


def _float_fmt(fmt: str, precision: int):
    """TxtFloatFormat (PDFWriter.cpp:25-48): `fixed` -> %.Nf,
    `scientific` -> %.Ne, `default` -> %.Ng."""
    if fmt == "fixed":
        return lambda x: f"{x:.{precision}f}"
    if fmt == "default":
        return lambda x: f"{x:.{precision}g}"
    return lambda x: f"{x:.{precision}e}"


def write_pdf_txt(path: str, pdf, fmt: str = "scientific",
                  precision: int = 12) -> None:
    counts = np.asarray(pdf.counts)
    n = counts.sum()
    F = _float_fmt(fmt, precision)
    with open(path, "w") as fh:
        if counts.ndim == 1:
            fh.write("# 1:x 2:pdf\n")
            dens = counts / (n * pdf.binsize)
            for i, d in enumerate(dens):
                if counts[i]:
                    x = pdf.lo + (i + 0.5) * pdf.binsize
                    fh.write(f"{F(x)}\t{F(d)}\n")
        elif counts.ndim == 2:
            fh.write("# 1:x 2:y 3:pdf\n")
            area = pdf.binsize[0] * pdf.binsize[1]
            for i in range(counts.shape[0]):
                for j in range(counts.shape[1]):
                    if counts[i, j]:
                        x = pdf.lo[0] + (i + 0.5) * pdf.binsize[0]
                        y = pdf.lo[1] + (j + 0.5) * pdf.binsize[1]
                        fh.write(f"{F(x)}\t{F(y)}\t"
                                 f"{F(counts[i, j] / (n * area))}\n")
        else:
            fh.write("# 1:x 2:y 3:z 4:pdf\n")
            volb = pdf.binsize[0] * pdf.binsize[1] * pdf.binsize[2]
            nz = np.nonzero(counts)
            for i, j, k in zip(*nz):
                x = pdf.lo[0] + (i + 0.5) * pdf.binsize[0]
                y = pdf.lo[1] + (j + 0.5) * pdf.binsize[1]
                z = pdf.lo[2] + (k + 0.5) * pdf.binsize[2]
                fh.write(f"{F(x)}\t{F(y)}\t{F(z)}\t"
                         f"{F(counts[i, j, k] / (n * volb))}\n")


def _bipdf_grid(pdf):
    counts = np.asarray(pdf.counts, dtype=float)
    nx, ny = counts.shape
    n = counts.sum()
    dens = counts / (n * pdf.binsize[0] * pdf.binsize[1])
    xs = pdf.lo[0] + np.arange(nx + 1) * pdf.binsize[0]
    ys = pdf.lo[1] + np.arange(ny + 1) * pdf.binsize[1]
    return xs, ys, dens


def write_pdf_gmsh(path: str, pdf, centering: str = "elem") -> None:
    """Bi-variate PDF as a Gmsh 2.2 quad mesh.

    centering `elem` writes the density as element data on the bins;
    `node` averages adjacent bins to the lattice nodes and writes node
    data (PDFCentering, PDFWriter.cpp:396)."""
    xs, ys, dens = _bipdf_grid(pdf)
    nx, ny = dens.shape
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n{(nx + 1) * (ny + 1)}\n")
        nid = lambda i, j: i * (ny + 1) + j + 1
        for i in range(nx + 1):
            for j in range(ny + 1):
                fh.write(f"{nid(i, j)} {xs[i]:.12g} {ys[j]:.12g} 0\n")
        fh.write("$EndNodes\n")
        fh.write(f"$Elements\n{nx * ny}\n")
        eid = 1
        for i in range(nx):
            for j in range(ny):
                fh.write(
                    f"{eid} 3 2 0 0 {nid(i, j)} {nid(i + 1, j)} "
                    f"{nid(i + 1, j + 1)} {nid(i, j + 1)}\n"
                )
                eid += 1
        fh.write("$EndElements\n")
        if centering == "node":
            acc = np.zeros((nx + 1, ny + 1))
            cnt = np.zeros((nx + 1, ny + 1))
            for di in (0, 1):
                for dj in (0, 1):
                    acc[di:nx + di, dj:ny + dj] += dens
                    cnt[di:nx + di, dj:ny + dj] += 1.0
            nodal = acc / cnt
            fh.write('$NodeData\n1\n"probability"\n1\n0.0\n3\n0\n1\n')
            fh.write(f"{(nx + 1) * (ny + 1)}\n")
            for i in range(nx + 1):
                for j in range(ny + 1):
                    fh.write(f"{nid(i, j)} {nodal[i, j]:.12e}\n")
            fh.write("$EndNodeData\n")
        else:
            fh.write('$ElementData\n1\n"probability"\n1\n0.0\n3\n0\n1\n')
            fh.write(f"{nx * ny}\n")
            eid = 1
            for i in range(nx):
                for j in range(ny):
                    fh.write(f"{eid} {dens[i, j]:.12e}\n")
                    eid += 1
            fh.write("$EndElementData\n")


def write_pdf_exodus(path: str, pdf) -> None:
    """Uni/bi/tri-variate PDF lattices as ExodusII: the bin-centre
    lattice as nodes with a nodal density field (the reference writes a
    QUAD/HEX8 block with elem-centered density, PDFWriter.cpp:992-1064;
    a point cloud over the same sample space reads in ParaView)."""
    counts = np.asarray(pdf.counts, dtype=float)
    n = counts.sum()
    if counts.ndim == 1:
        dens = counts / (n * pdf.binsize)
        X = pdf.lo + (np.arange(counts.shape[0]) + 0.5) * pdf.binsize
        Y = np.zeros_like(X)
        Z = np.zeros_like(X)
    elif counts.ndim == 2:
        xs, ys, dens = _bipdf_grid(pdf)
        cx = 0.5 * (xs[:-1] + xs[1:])
        cy = 0.5 * (ys[:-1] + ys[1:])
        X, Y = np.meshgrid(cx, cy, indexing="ij")
        Z = np.zeros_like(X)
    else:
        dens = counts / (n * pdf.binsize[0] * pdf.binsize[1]
                         * pdf.binsize[2])
        ctr = [pdf.lo[d] + (np.arange(counts.shape[d]) + 0.5)
               * pdf.binsize[d] for d in range(3)]
        X, Y, Z = np.meshgrid(*ctr, indexing="ij")
    write_exodus_points(path, X, Y, Z, "probability", dens)
