"""DG(P1) geometry of a tetrahedral mesh, built in torch on any device.

The plain reference's own tables, derived from the raw mesh (coordinates,
connectivity, boundary triangles by side set) that the benchmark also hands
to the program.  Nothing here comes from the program: faces are found by
one sort of the packed node triples, neighbours and Jacobians follow from
them, and the quadrature and Dubiner basis tables are written out below
(the rules of Quinoa's src/PDE/Integrate/Quadrature.cpp).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .order import hilbert_order

#: local nodes of the four faces of a tet, outward for a positive
#: Jacobian; face f is opposite local node f
TET_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
#: boundary codes the reference understands
BC_INTERIOR, BC_SYMMETRY, BC_EXTRAPOLATE = 0, 2, 3
_REF_NODES = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])


def _tet_rule(n):
    if n == 5:
        pts = np.array([[0.25, 0.25, 0.25], [1 / 6, 1 / 6, 1 / 6],
                        [0.5, 1 / 6, 1 / 6], [1 / 6, 0.5, 1 / 6],
                        [1 / 6, 1 / 6, 0.5]])
        return pts, np.array([-12.0 / 15.0] + [9 / 20] * 4)
    if n == 14:
        a, b = 0.0673422422100983, 0.3108859192633005
        c, d = 0.7217942490673264, 0.0927352503108912
        e, f = 0.4544962958743506, 0.0455037041256494
        p, q, r = 0.1126879257180162, 0.0734930431163619, 0.0425460207770812
        pts = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b],
                        [c, d, d], [d, c, d], [d, d, c], [d, d, d],
                        [e, e, f], [e, f, e], [e, f, f], [f, e, e],
                        [f, e, f], [f, f, e]])
        return pts, np.array([p] * 4 + [q] * 4 + [r] * 6)
    raise ValueError(n)


#: the 3-point triangle rule of the P1 faces (weights sum to 1)
TRI_PTS = np.array([[2 / 3, 1 / 6], [1 / 6, 2 / 3], [1 / 6, 1 / 6]])
TRI_W = np.array([1 / 3, 1 / 3, 1 / 3])


def basis(xi):
    """P1 Dubiner basis at reference points xi (3, ...) -> (4, ...)."""
    x, e, z = xi[0], xi[1], xi[2]
    return np.stack([np.ones_like(x), 2 * x + e + z - 1, 3 * e + z - 1,
                     4 * z - 1]) if isinstance(xi, np.ndarray) else \
        torch.stack([torch.ones_like(x), 2 * x + e + z - 1,
                     3 * e + z - 1, 4 * z - 1])


#: dB_k/dxi_m of the P1 basis (constant): (4, 3)
DBDXI = np.array([[0, 0, 0], [2, 1, 1], [0, 3, 1], [0, 0, 4]], dtype=float)


def tables():
    """float64 numpy quadrature and basis tables of DG(P1)."""
    vp, vw = _tet_rule(5)
    ip, iw = _tet_rule(14)
    mp, mw = _tet_rule(14)
    Bm = basis(mp.T)
    shp = np.stack([1 - TRI_PTS[:, 0] - TRI_PTS[:, 1], TRI_PTS[:, 0],
                    TRI_PTS[:, 1]], axis=1)                  # (G, 3)
    # the face points of each reference face, in the element's own
    # reference coordinates: (4, G, 3)
    selfpts = np.stack([shp @ _REF_NODES[list(f)] for f in TET_FACES])
    return dict(
        w_vol=vw, B_vol=basis(vp.T).T,                      # (Gv,), (Gv,K)
        wdB=vw[:, None, None] * DBDXI[None],                # (Gv,K,3)
        w_init=iw, xi_init=ip, B_init=basis(ip.T).T,        # (Gi,K)
        shp=shp, w_face=TRI_W,
        B_self=np.stack([basis(selfpts[f].T).T for f in range(4)]),  # (4,G,K)
        mnorm=(mw[:, None] * Bm.T * Bm.T).sum(axis=0),      # (K,)
    )


@dataclasses.dataclass
class Geom:
    vol: torch.Tensor      # (E,)
    jinv: torch.Tensor     # (3, 3, E)  dxi_m / dx_j
    jac: torch.Tensor      # (3, 3, E)  dx_i / dxi_m
    node0: torch.Tensor    # (3, E)
    esuel: torch.Tensor    # (4, E) long, -1 on the boundary
    el: torch.Tensor       # (F,) long
    er: torch.Tensor       # (F,) long, == el on boundary faces
    bctype: torch.Tensor   # (F,) long
    fn: torch.Tensor       # (3, F) unit normal, out of el
    farea: torch.Tensor    # (F,)
    B_l: torch.Tensor      # (K, G, F) basis of el at the face points
    B_r: torch.Tensor      # (K, G, F) basis of er at the face points
    tab: dict              # tensors of tables() in the working dtype

    @property
    def nelem(self):
        return self.vol.shape[0]

    @property
    def interior(self):
        return self.bctype == BC_INTERIOR

    def to(self, dtype):
        """The same geometry with every floating table in dtype."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "tab":
                v = {k: t.to(dtype) for k, t in v.items()}
            elif v.is_floating_point():
                v = v.to(dtype)
            out[f.name] = v
        return Geom(**out)


def build(coords, inpoel, bface, bc_codes, device, dtype=torch.float64):
    """(Geom, eorder) of a tet mesh: coords (N, 3), inpoel (E, 4) (numpy),
    bface {side set: (n, 3) triangles}, bc_codes {side set: BC code};
    boundary faces in no listed side set extrapolate.  The elements are
    taken in Hilbert order (order.py); eorder (new -> old) says where
    each came from."""
    eorder = hilbert_order(coords, inpoel)
    x = torch.as_tensor(np.asarray(coords, np.float64), device=device)
    tet = torch.as_tensor(np.asarray(inpoel, np.int64)[eorder], device=device)
    E, N = tet.shape[0], x.shape[0]
    if N >= 1 << 21:
        raise ValueError("the face keys pack 21 bits a node")
    n0 = x[tet[:, 0]]
    jac = torch.stack([x[tet[:, i]] - n0 for i in (1, 2, 3)], dim=2)
    det = torch.linalg.det(jac)
    if not bool((det > 0).all()):
        raise ValueError("mesh has non-positive element Jacobians")
    jinv = torch.linalg.inv(jac)

    faces = torch.tensor(TET_FACES, device=device)
    tri = tet[:, faces].reshape(-1, 3)                       # (4E, 3)
    key = torch.sort(tri, dim=1).values
    pk = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
    spk, order = torch.sort(pk, stable=True)
    eq = spk[:-1] == spk[1:]
    a, b = order[:-1][eq], order[1:][eq]                     # paired slots
    paired = torch.zeros(4 * E, dtype=torch.bool, device=device)
    paired[a] = True
    paired[b] = True
    bslot = torch.nonzero(~paired).squeeze(1)
    esuel = torch.full((E, 4), -1, dtype=torch.long, device=device)
    esuel[a // 4, a % 4] = b // 4
    esuel[b // 4, b % 4] = a // 4

    left = torch.cat([bslot, torch.minimum(a, b)])           # slot of el
    right = torch.cat([bslot, torch.maximum(a, b)])
    el, er = left // 4, right // 4
    fnodes = x[tri[left]]                                    # (F, 3, 3)
    nvec = torch.linalg.cross(fnodes[:, 1] - fnodes[:, 0],
                              fnodes[:, 2] - fnodes[:, 0])
    area2 = torch.linalg.norm(nvec, dim=1)
    fn = (nvec / area2[:, None]).T.contiguous()
    farea = 0.5 * area2

    nb = bslot.shape[0]
    bctype = torch.zeros(el.shape[0], dtype=torch.long, device=device)
    bctype[:nb] = BC_EXTRAPOLATE
    bkey = spk.new_empty(0)
    bcode = bkey.new_empty(0)
    for ss, code in bc_codes.items():
        t = torch.as_tensor(np.asarray(bface.get(ss, np.zeros((0, 3))),
                                       np.int64), device=device)
        k = torch.sort(t, dim=1).values
        bkey = torch.cat([bkey, (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]])
        bcode = torch.cat([bcode, torch.full_like(k[:, 0], code)])
    if bkey.numel():
        bk_sorted, bo = torch.sort(bkey)
        fkey = pk[bslot]
        pos = torch.clamp(torch.searchsorted(bk_sorted, fkey), max=len(bo) - 1)
        hit = bk_sorted[pos] == fkey
        bctype[:nb] = torch.where(hit, bcode[bo[pos]], bctype[:nb])

    tb = tables()
    shp = torch.as_tensor(tb["shp"], device=device)          # (G, 3)
    gp = torch.einsum("gi,fic->fgc", shp, fnodes)            # (F, G, 3)

    def face_basis(e):
        xi = torch.einsum("fmc,fgc->mgf", jinv[e], gp - n0[e][:, None, :])
        return basis(xi)                                     # (K, G, F)

    geom = Geom(
        vol=det / 6.0, jinv=jinv.permute(1, 2, 0).contiguous(),
        jac=jac.permute(1, 2, 0).contiguous(), node0=n0.T.contiguous(),
        esuel=esuel.T.contiguous(), el=el, er=er, bctype=bctype, fn=fn,
        farea=farea, B_l=face_basis(el), B_r=face_basis(er),
        tab={k: torch.as_tensor(v, device=device) for k, v in tb.items()})
    return (geom if dtype == torch.float64 else geom.to(dtype)), eorder
