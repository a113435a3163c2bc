"""Discontinuous-Galerkin core: geometry tables and operators on torch
tensors (feature-major layout).

Port of quinoa_tpu/pde/dg.py for the slice's case: coordinate-free faces
and every dof active (no dofmask).  Layout as in the JAX package: the modal
state is U (C*K, E) with row c*K+k, per-face slabs are (rows, F) and
coordinates (3, n); the element or face axis is always last.

build_dggeom builds the tables on the host with numpy exactly as the JAX
version does (same face order, fose, fsideR and esuelT), then moves them to
the requested device and dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from quinoa_tpu.mesh.derived import gen_faces, gen_esuel, _TET_FACES

from ..ops.basis import eval_basis_np, eval_dbdxi, mass_diag
from ..ops.quadrature import gauss_tet, gauss_tri, ng_vol, ng_face, ng_init

# BC type codes (per boundary face), as quinoa_tpu/pde/dg.py
BC_INTERIOR = 0
BC_DIRICHLET = 1
BC_SYMMETRY = 2
BC_EXTRAPOLATE = 3
BC_INLET = 4
BC_OUTLET = 5

_REF_NODES = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)

#: geometry fields that are tensors, in the JAX DGGeom's order
GEOM_TENSOR_FIELDS = (
    "vol", "jacInv", "Jmat", "node0", "emask",
    "el", "er", "fn", "farea", "xi_l", "xi_r", "bctype", "fmask",
    "fose", "fsideR", "esuelT",
)
#: the integer-valued ones (int32, as in the JAX package)
GEOM_INT_FIELDS = ("el", "er", "bctype", "fose", "esuelT")


@dataclasses.dataclass(frozen=True)
class DGGeom:
    """Static DG geometry tables (single device), as quinoa_tpu's DGGeom.

    vol     : (E,)        element volumes
    jacInv  : (3,3,E)     d(xi)/dx
    Jmat    : (3,3,E)     dx/d(xi)
    node0   : (3,E)       coordinates of local node 0
    emask   : (E,)        1.0 real / 0.0 padding
    el, er  : (F,) i32    left/right elements (er == el for boundary)
    fn      : (3,F)       unit face normal, outward from the left element
    farea   : (F,)        face area
    xi_l/r  : (3,G,F)     face Gauss points in left/right element ref coords
    bctype  : (F,) i32    BC code (interior 0)
    fmask   : (F,)        1.0 real face / 0.0 padding
    fose    : (4,E) i32   the element's four faces
    fsideR  : (4,E)       1.0 where the element is the RIGHT of that face
    esuelT  : (4,E) i32   face-neighbor elements (-1 = boundary)
    tables  : float64 numpy quadrature/basis tables
    """

    vol: torch.Tensor
    jacInv: torch.Tensor
    Jmat: torch.Tensor
    node0: torch.Tensor
    emask: torch.Tensor
    el: torch.Tensor
    er: torch.Tensor
    fn: torch.Tensor
    farea: torch.Tensor
    xi_l: torch.Tensor
    xi_r: torch.Tensor
    bctype: torch.Tensor
    fmask: torch.Tensor
    fose: torch.Tensor
    fsideR: torch.Tensor
    esuelT: torch.Tensor
    ndof: int
    nelem_real: int
    tables: dict

    @property
    def nelem(self) -> int:
        return self.vol.shape[0]

    @property
    def nface(self) -> int:
        return self.farea.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vol.dtype

    @property
    def device(self) -> torch.device:
        return self.vol.device

    @functools.cached_property
    def ktab(self) -> torch.Tensor:
        """The quadrature/basis constants the CUDA kernels read, packed
        flat in the geometry's dtype and device (layout: kernels.TAB_*)."""
        from ..kernels import pack_tables

        return pack_tables(self.tables, self.dtype, self.device)

    @functools.cached_property
    def has_coord_bc(self) -> bool:
        """True if some face is Dirichlet or inlet (its ghost state needs
        the face coordinates).  Cached: on a card it costs a sync."""
        bt = self.bctype
        return bool(((bt == BC_DIRICHLET) | (bt == BC_INLET)).any())


def _self_face_gauss(ng: int) -> np.ndarray:
    """Ref coords of the ng face Gauss points on the 4 ref-tet faces."""
    pts, _ = gauss_tri(ng)
    shp = np.stack([1.0 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]], axis=1)
    out = np.empty((4, ng, 3))
    for lf in range(4):
        out[lf] = shp @ _REF_NODES[_TET_FACES[lf]]
    return out


def _make_tables(ndof: int) -> dict:
    vp, vw = gauss_tet(ng_vol(ndof))
    _, tw = gauss_tri(ng_face(ndof))
    ip, iw = gauss_tet(ng_init(ndof))
    sf = _self_face_gauss(ng_face(ndof))
    return dict(
        w_vol=vw,
        xi_vol=vp,
        B_vol=eval_basis_np(ndof, vp),
        dBdxi_vol=eval_dbdxi(ndof, torch.from_numpy(vp)).numpy(),
        w_face=tw,
        w_init=iw,
        xi_init=ip,
        B_init=eval_basis_np(ndof, ip),
        B_selfface=np.stack([eval_basis_np(ndof, sf[lf]) for lf in range(4)]),
        mnorm=mass_diag(ndof),
    )


def build_dggeom(
    mesh,
    ndof: int,
    bc_sidesets: Optional[Dict[int, int]] = None,
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> DGGeom:
    """Build single-device DG geometry from a host UnsMesh.

    bc_sidesets maps side-set id -> BC code; unlisted boundary faces
    default to extrapolate.
    """
    from quinoa_tpu.native import build_fose as _native_fose
    from quinoa_tpu.native import face_xi as _native_face_xi

    coords, inpoel = mesh.coords, mesh.inpoel
    E = mesh.nelem

    n0 = coords[inpoel[:, 0]]
    Jm = np.stack(
        [
            coords[inpoel[:, 1]] - n0,
            coords[inpoel[:, 2]] - n0,
            coords[inpoel[:, 3]] - n0,
        ],
        axis=2,
    )  # (E,3,3)
    detJ = np.linalg.det(Jm)
    if not (detJ > 0).all():
        raise ValueError("mesh has non-positive element Jacobians")
    vol = detJ / 6.0
    jacInv = np.linalg.inv(Jm)

    fd = gen_faces(inpoel, mesh.nnode)
    esuf = fd["esuf"]
    inpofa = fd["inpofa"]
    nbfac = fd["nbfac"]
    F = esuf.shape[0]

    a = coords[inpofa[:, 0]]
    b = coords[inpofa[:, 1]]
    c = coords[inpofa[:, 2]]
    nvec = np.cross(b - a, c - a)
    farea = 0.5 * np.linalg.norm(nvec, axis=1)
    fn = nvec / (2.0 * farea[:, None])

    tp, _ = gauss_tri(ng_face(ndof))
    shp = np.stack([1.0 - tp[:, 0] - tp[:, 1], tp[:, 0], tp[:, 1]], axis=1)
    el = esuf[:, 0].astype(np.int64)
    er = np.where(esuf[:, 1] < 0, el, esuf[:, 1]).astype(np.int64)
    nat = _native_face_xi(coords, inpofa, shp, jacInv, n0, el, er)
    if nat is not None:  # the C++ host kernel: same values, one pass
        xi_l, xi_r = nat
    else:
        gp = np.einsum("gi,fid->fgd", shp, coords[inpofa])  # (F,G,3)
        xi_l = np.einsum("fij,fgj->fgi", jacInv[el], gp - n0[el][:, None, :])
        xi_r = np.einsum("fij,fgj->fgi", jacInv[er], gp - n0[er][:, None, :])

    bctype = np.zeros(F, dtype=np.int32)
    bctype[:nbfac] = BC_EXTRAPOLATE
    if bc_sidesets:
        key2f = {tuple(sorted(inpofa[i])): i for i in range(nbfac)}
        for ss, code in bc_sidesets.items():
            for tri in mesh.bface.get(ss, ()):
                f = key2f.get(tuple(sorted(tri)))
                if f is not None:
                    bctype[f] = code

    # faces sorted by their left element, as the JAX geometry (fose is
    # built from the sorted order, so face ids agree between packages)
    forder = np.argsort(el, kind="stable")
    el, er = el[forder], er[forder]
    fn, farea = fn[forder], farea[forder]
    xi_l, xi_r = xi_l[forder], xi_r[forder]
    bctype = bctype[forder]

    natf = _native_fose(el, er, E)
    if natf is not None:
        fose, fsideR = natf
    else:
        fose = np.zeros((4, E), dtype=np.int32)
        fsideR = np.zeros((4, E))
        slot = np.zeros(E, dtype=np.int64)
        for f in range(F):
            e = el[f]
            fose[slot[e], e] = f
            slot[e] += 1
            if er[f] != el[f]:
                e2 = er[f]
                fose[slot[e2], e2] = f
                fsideR[slot[e2], e2] = 1.0
                slot[e2] += 1
        if not (slot == 4).all():
            raise ValueError("every tet must own exactly 4 face slots")

    esuel = gen_esuel(inpoel, mesh.nnode)

    arrays = dict(
        vol=vol,
        jacInv=np.transpose(jacInv, (1, 2, 0)),
        Jmat=np.transpose(Jm, (1, 2, 0)),
        node0=n0.T,
        emask=np.ones(E),
        el=el,
        er=er,
        fn=fn.T,
        farea=farea,
        xi_l=np.transpose(xi_l, (2, 1, 0)),
        xi_r=np.transpose(xi_r, (2, 1, 0)),
        bctype=bctype,
        fmask=np.ones(F),
        fose=fose,
        fsideR=fsideR,
        esuelT=esuel.T,
        ndof=int(ndof),
        nelem_real=int(E),
        tables=_make_tables(ndof),
    )
    from ..convert import geom_from_arrays

    return geom_from_arrays(arrays, device=device, dtype=dtype)


# -- helpers -----------------------------------------------------------------


def uview(U, C, K):
    """(C*K, E) -> (C, K, E) view."""
    return U.reshape(C, K, U.shape[-1])


def _phys_gp(node0, Jmat, xi):
    """Physical coords (3, n) of ref point(s) xi ((3,) or (3, n))."""
    return torch.stack(
        [
            node0[i]
            + Jmat[i, 0] * xi[0] + Jmat[i, 1] * xi[1] + Jmat[i, 2] * xi[2]
            for i in range(3)
        ]
    )


def require_slice(system, geom: DGGeom):
    """Raise for what the port does not cover: anything but a P1,
    coordinate-free, source-free system on symmetry/extrapolate/outlet
    faces."""
    if geom.ndof != 4:
        raise NotImplementedError(f"ndof={geom.ndof}: only DG(P1) is ported")
    if getattr(system, "ncomp", None) != 5 or not getattr(
            system, "coord_free_flux", False):
        raise NotImplementedError("only compressible Euler (DGCompFlow) "
                                  "is ported")
    if system.has_src:
        raise NotImplementedError("source terms are not ported")
    if getattr(system, "riemann_flux", "hllc") != "hllc":
        raise NotImplementedError("the face kernel implements HLLC only")
    if geom.has_coord_bc:
        raise NotImplementedError("Dirichlet/inlet faces are not ported")


# -- operators ---------------------------------------------------------------


def dg_rhs(system, geom: DGGeom, U, dofmask=None, t=0.0, face_gp=False,
           want_charvel=False, vol_rhs=None):
    """DG right-hand side (C*K, E): volume + surface integrals, the plain
    torch formulation (no kernel launch on any device).

    Only the slice's case is ported: dofmask None (every dof active),
    coordinate-free faces, no source.  With want_charvel also returns
    delt (E,), the dt sweep's per-element summed charvel.  vol_rhs, when
    given, replaces the volume integral (the limit + volume pass made it).
    """
    if dofmask is not None or face_gp:
        raise NotImplementedError("dofmask / face Gauss-point coordinates "
                                  "are not ported")
    from ..ops.face_fused import face_flux_plain, face_to_elem_plain
    from ..ops.nbr_bounds import volume_rhs_plain

    Rv = volume_rhs_plain(system, geom, U) if vol_rhs is None else vol_rhs
    cL, cR, mx = face_flux_plain(system, geom, U)
    r, delt = face_to_elem_plain(geom, cL, cR, mx, Rv)
    return (r, delt) if want_charvel else r


def dg_dt(system, geom: DGGeom, U, dofmask=None):
    """Max-characteristic-speed face sweep: min_e vol_e / sum_f dSV
    (DGCompFlow.hpp dt:197-406)."""
    _, delt = dg_rhs(system, geom, U, dofmask, want_charvel=True)
    return dg_dt_from_delt(geom, delt)


def dg_dt_from_delt(geom: DGGeom, delt):
    """min_e vol_e / delt_e from the per-element summed charvel.  The
    1e-300 floor rounds to 0 in float32, as in the JAX package."""
    big = torch.finfo(delt.dtype).max
    elemdt = geom.vol / torch.clamp_min(delt, 1e-300)
    return torch.where(geom.emask > 0, elemdt, big).min()


def dg_initialize(system, geom: DGGeom, t):
    """L2 projection of the IC onto the modal basis (tk::initialize).
    Returns (C*K, E)."""
    C, K, E = system.ncomp, geom.ndof, geom.nelem
    tb = geom.tables
    dtype, dev = geom.dtype, geom.device
    xi = torch.as_tensor(tb["xi_init"].T, dtype=dtype, device=dev)  # (3,G)
    gp = geom.node0[:, None, :] + torch.einsum("ime,mg->ige", geom.Jmat, xi)
    f = system.initialize(gp, t)                          # (C,G,E)
    wB = torch.as_tensor(tb["w_init"][:, None] * tb["B_init"], dtype=dtype,
                         device=dev)
    proj = torch.einsum("gk,cge->cke", wB, f)
    mn = torch.as_tensor(tb["mnorm"], dtype=dtype, device=dev)
    return (proj / mn[None, :, None]).reshape(C * K, E)
