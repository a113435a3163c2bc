"""Discontinuous-Galerkin core: geometry tables and operators on torch
tensors (feature-major layout).

Port of quinoa_tpu/pde/dg.py for DG(P0), DG(P1) and DG(P2): the fused
face passes of coordinate-free compressible Euler, the volume integral
with a manufactured source, the face Gauss-point path (transport,
Dirichlet and inlet faces, any dofmask; P0, P1 and P2, for a flux of any
number of rows), the p-adaptive dofmask and its indicator, and the cell
average.
Layout as in the JAX package: the modal state is U (C*K, E) with row
c*K+k, per-face slabs are (rows, F) and coordinates (3, n); the element or
face axis is always last.

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

from ..base.profiler import count, span
from ..device import DEFAULT_DEVICE, resolve_device
from ..mesh.derived import _TET_FACES, gen_esuel, gen_faces
from ..ops.basis import eval_basis_cm, eval_basis_np, eval_dbdxi, mass_diag
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
    def w_face(self) -> torch.Tensor:
        """The face quadrature weights (G,) in the geometry's dtype and
        device, as the face kernels K12/K13 read them."""
        return torch.as_tensor(self.tables["w_face"], dtype=self.dtype,
                               device=self.device)

    @functools.cached_property
    def wB_vol(self) -> torch.Tensor:
        """w_vol * B_vol (Gv, K) in the geometry's dtype and device, the
        test functions of the volume points' integrals, as the multimat
        volume kernel K16 reads them."""
        tb = self.tables
        return torch.as_tensor(tb["w_vol"][:, None] * tb["B_vol"],
                               dtype=self.dtype, device=self.device)

    @functools.cached_property
    def face_gp(self) -> torch.Tensor:
        """Physical coordinates (3, G, F) of the face Gauss points, from
        the left element (quinoa_tpu/pde/dg.py:413-416).  Cached: they
        depend on the geometry only."""
        el = self.el.long()
        return _phys_gp(self.node0[:, None, el], self.Jmat[:, :, None, el],
                        self.xi_l)

    @functools.cached_property
    def vol_gp(self) -> torch.Tensor:
        """Physical coordinates (3, Gv, E) of the volume Gauss points."""
        xi = torch.as_tensor(self.tables["xi_vol"].T, dtype=self.dtype,
                             device=self.device)[:, :, None]
        return _phys_gp(self.node0[:, None], self.Jmat[:, :, None], xi)

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


def face_xi(coords, inpofa, shp, jacInv, n0, el, er):
    """Reference coordinates (F, G, 3) of the face Gauss points in the left
    and right elements: xi = jacInv[e] (gp - n0[e]), gp = sum_i shp[g, i]
    x_i, each sum in the order of the JAX package's native face_xi."""
    p = coords[inpofa]                                         # (F, 3, 3)
    gp = (shp[None, :, 0, None] * p[:, None, 0]
          + shp[None, :, 1, None] * p[:, None, 1]
          + shp[None, :, 2, None] * p[:, None, 2])             # (F, G, 3)

    def xi(e):
        Ji = jacInv[e][:, None]                                # (F,1,3,3)
        d = gp - n0[e][:, None, :]
        return (Ji[..., 0] * d[..., 0, None] + Ji[..., 1] * d[..., 1, None]
                + Ji[..., 2] * d[..., 2, None])

    return xi(el), xi(er)


def build_fose(el: np.ndarray, er: np.ndarray, nelem: int):
    """Faces of each element, (fose (4, E) int32, fsideR (4, E)): an
    element's four slots list its faces in face order, fsideR 1.0 where
    it is the face's right side (the sequential slot fill of the JAX
    build_dggeom, vectorized)."""
    F = len(el)
    inner = np.nonzero(er != el)[0]
    elem = np.concatenate([el, er[inner]])
    face = np.concatenate([np.arange(F), inner])
    side = np.concatenate([np.zeros(F), np.ones(len(inner))])
    order = np.lexsort((face, elem))
    counts = np.bincount(elem, minlength=nelem)
    if not (counts == 4).all():
        raise ValueError("every tet must own exactly 4 face slots")
    fose = np.empty((4, nelem), dtype=np.int32)
    fsideR = np.empty((4, nelem))
    slot = np.arange(len(order)) % 4   # sorted by element: 4 per element
    fose[slot, elem[order]] = face[order]
    fsideR[slot, elem[order]] = side[order]
    return fose, fsideR


def build_dggeom(
    mesh,
    ndof: int,
    bc_sidesets: Optional[Dict[int, int]] = None,
    dtype: torch.dtype = torch.float64,
    device=DEFAULT_DEVICE,
) -> DGGeom:
    """Build single-device DG geometry from a host UnsMesh, on the card
    unless ``device`` says otherwise.

    bc_sidesets maps side-set id -> BC code; unlisted boundary faces
    default to extrapolate.  Its spans (base/profiler.py): geometry, and
    inside it the host phases geometry.jacobians, geometry.faces,
    geometry.face_tables and geometry.fose, then geometry.upload, the
    copies onto the device.
    """
    with span("geometry"):
        return _build_dggeom(mesh, ndof, bc_sidesets, dtype,
                             resolve_device(device))


def _build_dggeom(mesh, ndof, bc_sidesets, dtype, device) -> DGGeom:
    coords, inpoel = mesh.coords, mesh.inpoel
    E = mesh.nelem

    with span("geometry.jacobians"):
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

    with span("geometry.faces"):
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

    with span("geometry.face_tables"):
        tp, _ = gauss_tri(ng_face(ndof))
        shp = np.stack([1.0 - tp[:, 0] - tp[:, 1], tp[:, 0], tp[:, 1]],
                       axis=1)
        el = esuf[:, 0].astype(np.int64)
        er = np.where(esuf[:, 1] < 0, el, esuf[:, 1]).astype(np.int64)
        xi_l, xi_r = face_xi(coords, inpofa, shp, jacInv, n0, el, er)

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

    with span("geometry.fose"):
        fose, fsideR = build_fose(el, er, E)
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

    with span("geometry.upload"):
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


def require_fused_physics(system, geom: DGGeom, face_pass: bool = False,
                          ndofs=(4,), fluxes=("hllc",)):
    """Raise unless the fused kernels cover the case, compressible Euler
    with a coordinate-free flux at an ndof in ndofs: kernel K1 (the limit
    + flux volume pass of DG(P1); a source term is the caller's, see
    source_rhs); with face_pass the face
    passes on faces whose ghost needs no coordinates, with a Riemann flux
    in fluxes (K12 + K13 implement HLLC and Lax-Friedrichs)."""
    if geom.ndof not in ndofs:
        raise NotImplementedError(f"ndof={geom.ndof}: the fused kernels "
                                  f"here take ndof in {tuple(ndofs)}")
    if not getattr(system, "coord_free_flux", False):
        raise NotImplementedError("the fused kernels implement compressible "
                                  "Euler only")
    if face_pass:
        flux = getattr(system, "riemann_flux", "hllc")
        if flux not in fluxes:
            raise NotImplementedError(f"this face pass implements "
                                      f"{' and '.join(fluxes)}, not {flux}")
        if geom.has_coord_bc:
            raise NotImplementedError("the face kernel has no Dirichlet/"
                                      "inlet ghost (face Gauss-point path)")


# -- operators ---------------------------------------------------------------


def dofmask_of(ndofel, ndof, dtype):
    """The p-adaptive dofmask (ndof, E): 1 where dof k < ndofel[e]."""
    k = torch.arange(ndof, device=ndofel.device)[:, None]
    return (k < ndofel[None, :]).to(dtype)


def _masked(U, dofmask, C):
    """U with the inactive dofs zeroed (U itself without a dofmask)."""
    return U if dofmask is None else U * dofmask.repeat(C, 1)


def _face_states(geom: DGGeom, Um, C):
    """Left and right states (C, G, F) at the face Gauss points and the
    basis (K, G, F) on each side.  The modal states of el and er come
    through the face gather (kernel K5 on a card)."""
    from ..ops.face_accum import face_gather

    K, F = geom.ndof, geom.nface
    out = []
    for idx, xi in ((geom.el, geom.xi_l), (geom.er, geom.xi_r)):
        Uf = face_gather(Um, idx).reshape(C, K, F)
        B = eval_basis_cm(K, xi)                         # (K,G,F)
        s = B[0] * Uf[:, 0, None]
        for k in range(1, K):
            s = s + B[k] * Uf[:, k, None]
        out += [s, B]
    return out


def volume_rhs(system, geom: DGGeom, U, t=0.0):
    """Volume and source integrals (C*K, E) of U, scaled by vol*emask, in
    the JAX package's XLA formulation (quinoa_tpu/pde/dg.py:342-370):
    einsums over the (G, K) tables, the flux columns at the volume points,
    the jacInv contraction (skipped at K = 1, where the test function has
    no gradient, as :357 skips it), and w*B times the source at (gp, t)
    when the system has one.  The volume term of the DG(P0) and DG(P2)
    routes: products the JAX package leaves to XLA, so they stay torch
    here.  A multimat system at P1 takes its volume pass instead
    (pde/multimat.py mm_volume: kernel K16 on a card)."""
    C, K, E = system.ncomp, geom.ndof, U.shape[-1]
    if K == 4 and hasattr(system, "nmat"):
        from .multimat import mm_volume

        return mm_volume(system, geom, U)
    tb = geom.tables
    dt_, dev = U.dtype, U.device
    count("host_syncs", 2)              # the two uploads below
    B_vol = torch.tensor(tb["B_vol"], dtype=dt_, device=dev)       # (G,K)
    wdB = torch.tensor(tb["w_vol"][:, None, None] * tb["dBdxi_vol"],
                       dtype=dt_, device=dev)                     # (G,K,3)
    gp = geom.vol_gp                                              # (3,G,E)
    if K > 1:
        state = torch.einsum("gk,cke->cge", B_vol, uview(U, C, K))  # (C,G,E)
        Fj = system.flux_cols(state, gp, t)
        J = geom.jacInv
        Fref = torch.stack([Fj[0] * J[m, 0] + Fj[1] * J[m, 1]
                            + Fj[2] * J[m, 2] for m in range(3)])  # (3,C,G,E)
        Rv = torch.einsum("gkm,mcge->cke", wdB, Fref)
    else:
        Rv = U.new_zeros((C, K, E))
    if system.has_src:
        count("host_syncs")
        wB = torch.tensor(tb["w_vol"][:, None] * tb["B_vol"], dtype=dt_,
                          device=dev)                             # (G,K)
        Rv = Rv + torch.einsum("gk,cge->cke", wB, system.src(gp, t))
    return (Rv * (geom.vol * geom.emask)).reshape(C * K, E)


def source_rhs(system, geom: DGGeom, t):
    """The source integral (C*K, E) alone, w*B times the source at the
    volume Gauss points and t, scaled by vol*emask: what the DG(P1) step
    adds to the limit + volume kernel's flux integral (K1 has no source
    term).  The JAX package sums it into the flux integral before the
    scaling (quinoa_tpu/pde/dg.py:364-370); the two differ by round-off."""
    C, K = system.ncomp, geom.ndof
    tb = geom.tables
    count("host_syncs")
    wB = torch.tensor(tb["w_vol"][:, None] * tb["B_vol"], dtype=geom.dtype,
                      device=geom.device)                         # (G,K)
    Rs = torch.einsum("gk,cge->cke", wB, system.src(geom.vol_gp, t))
    return (Rs * (geom.vol * geom.emask)).reshape(C * K, -1)


def volume_term(system, ndof, face_gp=True):
    """The volume term of a DG rhs where no limit pass made one: 'plain'
    (volume_rhs_plain, K1's sum order) at P1 without a source, 'none' on
    the fused face pass at P0 without one, else 'xla' (volume_rhs)."""
    if system.has_src or ndof == 10 or (ndof == 1 and face_gp):
        return "xla"
    return "plain" if ndof == 4 else "none"


def no_plan(accum_plan):
    """The JAX package's accumulation-plan slot, which must be None: the
    port has no plans (the card gathers and sums directly)."""
    if accum_plan is not None:
        raise ValueError("the port has no accumulation plans: accum_plan "
                         "must be None")


def dg_rhs(system, geom: DGGeom, U, dofmask, t, accum_plan=None,
           face_gp=True, want_charvel=False, vol_rhs=None):
    """DG right-hand side (C*K, E): volume + surface integrals, in the
    JAX package's parameter layout (quinoa_tpu/pde/dg.py:312-313).

    dofmask (K, E) or None (every dof active): the state is masked and
    so is the result, as in quinoa_tpu/pde/dg.py:330-333, :451-452.
    accum_plan must be None (no_plan).
    The volume integral includes the system's source, if any (the
    XLA formulation, volume_rhs; without a source at P1 the sum order of
    the limit + volume kernel, volume_rhs_plain).  face_gp=False without
    a dofmask takes the fused face pass where the JAX package takes its
    fused kernels (fused_face_pass: K12 + K13 on a card at every order and
    flux; compressible Euler on coordinate-free faces only); with
    want_charvel it also returns delt (E,), the dt sweep's per-element
    summed charvel.  Otherwise (the JAX default face_gp=True, or a
    dofmask) it takes the face Gauss-point path (:396-453): face states
    through the gather (K5), ghosts and the flux at the face coordinates
    in torch, element sums through the accumulation (K6).  vol_rhs, when
    given, replaces the volume integral (the limit + volume pass made it).
    t is the time the boundary ghosts, the flux and the source see.
    """
    no_plan(accum_plan)
    face_gp = face_gp or dofmask is not None
    if face_gp and want_charvel:
        raise ValueError("the face Gauss-point path has no charvel: use "
                         "dg_dt")
    from ..ops.face_accum import accumulate_faces
    from ..ops.face_fused import fused_face_pass
    from ..ops.nbr_bounds import volume_rhs_plain

    C, K = system.ncomp, geom.ndof
    Um = _masked(U, dofmask, C)
    if vol_rhs is not None:
        Rv = vol_rhs
    else:
        with span("volume"):
            Rv = (volume_rhs_plain if volume_term(system, K) == "plain"
                  else volume_rhs)(system, geom, Um, t)
    with span("face_pass"):
        if face_gp:
            # the test functions are not masked: the rows they would zero
            # belong to inactive dofs, which the dofmask below zeroes
            # anyway
            r = accumulate_faces(geom, *face_gp_rows(system, geom, Um, t),
                                 Rv)
            delt = None
        else:
            r, delt = fused_face_pass(system, geom, Um, vol_rhs=Rv)
        if dofmask is not None:
            r = r * dofmask.repeat(C, 1)
    return (r, delt) if want_charvel else r


def face_gp_rows(system, geom: DGGeom, Um, t):
    """The face Gauss-point path's per-face rows (-cL, cR), each (R*K, F),
    that the accumulation (K6) sums onto the left and right elements
    (quinoa_tpu/pde/dg.py:396-444): the states of the system.ncomp rows of
    Um at the face points through the gather (K5), the boundary ghosts at
    the face coordinates and t, the system's flux (R rows, R = ncomp for
    a conservative system, more for the multimat facade's riemannDeriv
    rows), weighted by w_g * area and contracted with each side's basis
    in point order."""
    K = geom.ndof
    sL, B_l, sR, B_r = _face_states(geom, Um, system.ncomp)
    gpf, fnf = geom.face_gp, geom.fn[:, None, :]
    sR = torch.where(geom.bctype == BC_INTERIOR, sR,
                     system.bc_state(geom.bctype, sL, fnf, gpf, t))
    fl = system.riemann(fnf, sL, sR, gpf, t)             # (R,G,F)
    R = fl.shape[0]
    wt = geom.farea * geom.fmask
    wface = geom.tables["w_face"]
    cL = cR = None
    for g in range(len(wface)):
        wfl = fl[:, g] * (float(wface[g]) * wt)          # (R,F)
        tl = B_l[:, g][None] * wfl[:, None]              # (R,K,F)
        tr = B_r[:, g][None] * wfl[:, None]
        cL, cR = (tl, tr) if g == 0 else (cL + tl, cR + tr)
    return -cL.reshape(R * K, -1), cR.reshape(R * K, -1)


def dg_dt(system, geom: DGGeom, U, dofmask=None):
    """Max-characteristic-speed face sweep: min_e vol_e / sum_f dSV
    (DGCompFlow.hpp dt:197-406; quinoa_tpu/pde/dg.py:456-492)."""
    from ..ops.face_fused import delt_plain

    Um = _masked(U, dofmask, system.ncomp)
    sL, _, sR, _ = _face_states(geom, Um, system.ncomp)
    gpf = geom.face_gp if getattr(system, "needs_face_gp", True) else None
    fnf = geom.fn[:, None, :]
    dSV_l = system.charvel(sL, fnf, gpf)                 # (G,F)
    dSV_r = system.charvel(sR, fnf, gpf)
    wt = torch.as_tensor(geom.tables["w_face"], dtype=U.dtype,
                         device=U.device)[:, None] * (geom.farea * geom.fmask)
    interior = geom.bctype == BC_INTERIOR
    mx = (wt * torch.where(interior, torch.maximum(dSV_l, dSV_r),
                           dSV_l)).sum(0)
    return dg_dt_from_delt(geom, delt_plain(geom, mx))


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


def eval_ndof_sticky(geom: DGGeom, u, ndofel, ncomp, tolref):
    """p-adaptive indicator: keep P1 where any component's
    reference-space gradient magnitude exceeds tolref (DG.cpp
    eval_ndof:1089-1163; quinoa_tpu/pde/dg.py:519-540).  Sticky: only
    elements currently at ndof==4 are re-evaluated; a dropped element
    comes back only through propagate_ndof's ring promotion."""
    K = geom.ndof
    Uv = uview(u, ncomp, K)
    u1, u2, u3 = Uv[:, 1, :], Uv[:, 2, :], Uv[:, 3, :]
    dxi = (2.0 * u1, u1 + 3.0 * u2, u1 + u2 + 4.0 * u3)
    grad2 = None
    for j in range(3):
        d = (dxi[0] * geom.jacInv[0, j] + dxi[1] * geom.jacInv[1, j]
             + dxi[2] * geom.jacInv[2, j])
        grad2 = d * d if grad2 is None else grad2 + d * d
    keep = (torch.sqrt(grad2) > tolref).any(dim=0)
    fresh = torch.where(keep, 4, 1).to(torch.int32)
    return torch.where(ndofel == 4, fresh, ndofel)


def propagate_ndof(geom: DGGeom, ndofel):
    """p-refine every face neighbour of a p-refined element, one ring per
    step (DG.cpp propagate_ndof:1286-1313).  Non-transitive: reads
    ndofel and writes a new tensor."""
    nbr = ndofel[torch.clamp_min(geom.esuelT, 0).long()]   # (4,E)
    prom = ((nbr == 4) & (geom.esuelT >= 0)).any(dim=0)
    return torch.where(prom, 4, ndofel).to(torch.int32)


def dg_cell_avg(U, C, K):
    """Cell averages (C, E): the 0th Dubiner dof is the mean."""
    return uview(U, C, K)[:, 0, :]
