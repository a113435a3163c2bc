"""The ALECG stage rhs as three kernels: element term, edge dissipation
and node assembly.

Port of quinoa_tpu/ops/alecg_fused.py and the parts of
ops/window_kernels.py its passes use.  The TPU version runs each RK
stage's rhs as two window passes (element slots, edge slots) that gather
the nodal state through one-hot MXU windows, evaluate the entity math,
accumulate into lo/hi node windows and fold the far slots through a
second kernel, because a TPU core cannot gather or scatter in HBM.  None
of those devices (NodePlan windows, accumulators, one-hot contractions,
the far stream and its fold, pad blending) carries over: a card gathers
node values directly, and a make_cggeom geometry has no pad entities.
Here:

- K7 alecg_vol (csrc/alecg_vol.cu), one thread per element: cv (C, E),
  the element term -(V/4) sum_b grad_b . F(u_b);
- K8 alecg_edge (csrc/alecg_edge.cu), one thread per edge: d (C, nE),
  the edge Rusanov term w (u_b - u_a);
- K9 cg_assemble (csrc/cg_assemble.cu), one thread per node: the sum of
  its element slots of cv and its edge slots of +-d, level by level.

Each comes in the flavour of the system (``system.flavour``): transport
reads static node velocities and a static edge weight A*lambda;
compflow evaluates the EoS and Euler flux per corner and the charspeed
per endpoint.  The static rows are built once per geometry
(build_alecg_rows).  The plain versions evaluate the JAX package's XLA
formulation (quinoa_tpu/inciter/alecg.py:117-147) in the kernels' order;
a CPU tensor takes them, a CUDA tensor launches the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from .assembly import assemble_add, gather_nodes


@dataclasses.dataclass(frozen=True)
class ALECGRows:
    """Static per-entity rows of the stage rhs.

    w   : (E,)            V/4 = J*emask/24
    vel : (Cv, 3, N)      transport: the flux velocity at each node
                          (velocity(coords, 0)), read at an element's
                          corners through inpoelT; Cv = 1 when every
                          component has the same velocity, else C; None
                          for compflow
    ew  : (nE,)           transport: A*lambda, lambda the larger corner
                          charspeed; compflow: A
    """

    w: torch.Tensor
    vel: Optional[torch.Tensor]
    ew: torch.Tensor


def build_alecg_rows(system, geom, edget) -> ALECGRows:
    """The static rows of ``system``'s flavour, in the geometry's dtype and
    device.  The velocity is pointwise in the coordinates, so its value at
    a node is the JAX package's corner row at every corner of that node
    (coords_n[b] is coords gathered through inpoelT[b]).  The transport
    charspeed reads the coordinates only, as the XLA path's does
    (quinoa_tpu/pde/cg.py:268-270)."""
    w = (geom.J * geom.emask) / 24.0
    flavour = getattr(system, "flavour", None)
    if flavour == "transport":
        vel = system.problem.velocity(geom.coords, 0.0)  # (C, 3, N)
        if all(torch.equal(vel[c], vel[0]) for c in range(1, vel.shape[0])):
            vel = vel[:1]
        vel = vel.contiguous()
        lam = torch.maximum(system.charspeed(None, edget.xyz[0]),
                            system.charspeed(None, edget.xyz[1]))
        return ALECGRows(w=w, vel=vel, ew=(edget.A * lam).contiguous())
    if flavour == "compflow":
        return ALECGRows(w=w, vel=None, ew=edget.A.contiguous())
    raise NotImplementedError(f"no ALECG kernels for system flavour "
                              f"{flavour!r}")


def alecg_vol_plain(system, geom, rows: ALECGRows, u):
    """K7's plain version: cv (C, E) = -w * sum_b sum_j grad_bj * F_j(u_b),
    corners b and directions j in order (alecg.py:121-130)."""
    un = gather_nodes(u, geom.inpoelT)  # (4, C, E)
    divF = None
    for b in range(4):
        if rows.vel is not None:
            vb = rows.vel[:, :, geom.inpoelT[b].long()]  # (Cv, 3, E)
            fb = [vb[:, j] * un[b] for j in range(3)]
        else:
            fb = system.flux_at_nodes(un[b], None)
        g = geom.grad[b]
        d = g[0] * fb[0] + g[1] * fb[1] + g[2] * fb[2]
        divF = d if divF is None else divF + d
    return -rows.w * divF


def alecg_edge_plain(system, edget, rows: ALECGRows, u):
    """K8's plain version: d (C, nE) = w * (u_b - u_a), w = A*lambda
    (alecg.py:136-145)."""
    ua = u[:, edget.edges[0].long()]
    ub = u[:, edget.edges[1].long()]
    if rows.vel is not None:
        return rows.ew * (ub - ua)
    lam = torch.maximum(system.charspeed(ua, None), system.charspeed(ub, None))
    return rows.ew * lam * (ub - ua)


def cg_assemble_plain(cv, d, nsup, ensup):
    """K9's plain version: the element slots of cv (the same value at all
    four corners) plus the edge slots [d, -d], each assembled from slot
    level 0 (assembly.assemble_add), then added."""
    vol = assemble_add(cv[None].expand((4,) + tuple(cv.shape)), nsup)
    dis = assemble_add(torch.stack([d, -d]), ensup)
    return vol + dis


def alecg_vol(system, geom, rows: ALECGRows, u):
    """cv (C, E): K7 on a CUDA tensor, its plain version on a CPU one."""
    if u.device.type == "cpu":
        return alecg_vol_plain(system, geom, rows, u)
    if rows.vel is not None:
        return kernels.alecg_vol(u, geom.inpoelT, geom.grad, rows.w,
                                 rows.vel)
    return kernels.alecg_vol_cf(u, geom.inpoelT, geom.grad, rows.w,
                                system.eos)


def alecg_edge(system, edget, rows: ALECGRows, u):
    """d (C, nE): K8 on a CUDA tensor, its plain version on a CPU one."""
    if u.device.type == "cpu":
        return alecg_edge_plain(system, edget, rows, u)
    if rows.vel is not None:
        return kernels.alecg_edge(u, edget.edges, rows.ew)
    return kernels.alecg_edge_cf(u, edget.edges, rows.ew, system.eos)


def cg_assemble(cv, d, nsup, ensup):
    """r (C, N): K9 on a CUDA tensor, its plain version on a CPU one."""
    if cv.device.type == "cpu":
        return cg_assemble_plain(cv, d, nsup, ensup)
    return kernels.cg_assemble(cv, d, nsup, ensup)


def alecg_rhs(system, geom, edget, rows: ALECGRows, u):
    """The stage rhs (C, N): volume term + edge dissipation, assembled to
    the nodes (K7, K8, K9)."""
    return cg_assemble(alecg_vol(system, geom, rows, u),
                       alecg_edge(system, edget, rows, u), geom.nsup,
                       edget.ensup)
