"""Initial-mesh statistics (the inciter command's -v).

The port's own copy of quinoa_tpu/mesh/stats.py, the reference
Transporter's mesh-statistics echo (src/Inciter/Transporter.cpp:735-846
minstat/maxstat/sumstat/pdfstat/stat): min/max/avg of the edge lengths,
of the cube roots of the cell volumes and of the tets per chunk, and the
three setup PDF files (mesh_edge_pdf.txt, mesh_vol_pdf.txt,
mesh_ntet_pdf.txt).  numpy on the host, once at setup.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from .derived import gen_inpoed


def _edge_lengths(coords: np.ndarray, inpoel: np.ndarray) -> np.ndarray:
    edges = gen_inpoed(inpoel)
    d = coords[edges[:, 1]] - coords[edges[:, 0]]
    return np.sqrt((d * d).sum(axis=1))


def _cbrt_volumes(coords: np.ndarray, inpoel: np.ndarray) -> np.ndarray:
    a = coords[inpoel[:, 1]] - coords[inpoel[:, 0]]
    b = coords[inpoel[:, 2]] - coords[inpoel[:, 0]]
    c = coords[inpoel[:, 3]] - coords[inpoel[:, 0]]
    vol = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
    return np.cbrt(vol)


def mesh_statistics(mesh, chunk_nelem: Sequence[int] = ()) -> Dict:
    """min/max/avg of edge length, V^{1/3} and tets per chunk, with the
    samples; chunk_nelem defaults to one chunk of the whole mesh."""
    coords = np.asarray(mesh.coords, dtype=np.float64)
    el = _edge_lengths(coords, mesh.inpoel)
    cv = _cbrt_volumes(coords, mesh.inpoel)
    nt = np.asarray(list(chunk_nelem) or [mesh.nelem], dtype=np.float64)
    return {
        "edgelength": (el.min(), el.max(), el.mean()),
        "V^{1/3}": (cv.min(), cv.max(), cv.mean()),
        "ntets": (nt.min(), nt.max(), nt.mean()),
        "_edge_samples": el,
        "_vol_samples": cv,
        "_ntet_samples": nt,
    }


def format_mesh_statistics(stats: Dict) -> str:
    """The reference's three echo lines (Transporter::stat)."""
    lines = []
    for key in ("edgelength", "V^{1/3}", "ntets"):
        mn, mx, av = stats[key]
        if key == "ntets":
            lines.append(
                f"Mesh statistics: min/max/avg({key}) = "
                f"{int(mn)} / {int(mx)} / {int(av)}")
        else:
            lines.append(
                f"Mesh statistics: min/max/avg({key}) = "
                f"{mn:.6f} / {mx:.6f} / {av:.6f}")
    return "\n".join(lines)


def write_mesh_pdfs(stats: Dict, outdir: str = ".") -> None:
    """mesh_edge_pdf.txt, mesh_vol_pdf.txt and mesh_ntet_pdf.txt
    (Transporter::pdfstat) through the txt PDF writer: bins of 1e-4 (1 for
    the tet counts), widened to a thousandth of the range where that
    would exceed 2,000,000 bins."""
    from ..io.pdfwriter import write_pdf_txt
    from ..statistics.pdf import UniPDF

    for fname, key, binsize in (
        ("mesh_edge_pdf.txt", "_edge_samples", 1e-4),
        ("mesh_vol_pdf.txt", "_vol_samples", 1e-4),
        ("mesh_ntet_pdf.txt", "_ntet_samples", 1.0),
    ):
        x = np.asarray(stats[key], dtype=np.float64)
        lo = np.floor(x.min() / binsize) * binsize
        nbins = max(int(np.ceil((x.max() - lo) / binsize)) + 1, 1)
        if nbins > 2_000_000:  # degenerate binsize for this mesh scale
            binsize = (x.max() - lo) / 1000 or 1.0
            nbins = max(int(np.ceil((x.max() - lo) / binsize)) + 1, 1)
        counts, _ = np.histogram(
            x, bins=nbins, range=(lo, lo + nbins * binsize))
        pdf = UniPDF(binsize=binsize, lo=float(lo), counts=counts)
        write_pdf_txt(os.path.join(outdir, fname), pdf)
