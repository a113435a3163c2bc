"""The port's public entries of the per-layer operations on sedov_pdg's
solver (quinoa_tpu_torch.inciter.dg.DGSolver at DG(P1) with Superbee
and pref), each with the shapes work/<operation>.py counts its bytes
from:

- pref_limit: the stage-0 p-adaptive limit pass as the step runs it:
  the sticky indicator (pde/dg.py eval_ndof_sticky), the one-ring
  promotion (propagate_ndof), the dofmask, the neighbour-mean bounds
  (ops/nbr_bounds.py neighbor_mean_bounds, K4), Superbee with the
  dofmask (pde/limiter.py superbee_p1) and the zeroing of the P0
  elements' slopes;
- face_pass: the face pass (K12 + K13) on the state masked by its
  dofmask, as the step takes it."""


def ops(solver, state):
    import torch

    from quinoa_tpu_torch.ops.nbr_bounds import neighbor_mean_bounds
    from quinoa_tpu_torch.pde.dg import eval_ndof_sticky, propagate_ndof
    from quinoa_tpu_torch.pde.limiter import superbee_p1

    g, sy, u, nd = solver.geom, solver.system, state.u, state.ndofel
    C, K = sy.ncomp, g.ndof
    k = torch.arange(K, device=u.device)[:, None]

    def dofmask(ndofel):
        return (k < ndofel[None, :]).to(u.dtype)

    def pref_limit():
        ndofel = propagate_ndof(g, eval_ndof_sticky(g, u, nd, C, solver.tolref))
        dm = dofmask(ndofel)
        ul = superbee_p1(g, u, dm, C, bounds=neighbor_mean_bounds(g, u, C))
        return ul * dm.repeat(C, 1), ndofel

    um = u * dofmask(nd).repeat(C, 1)
    sh = {"nelem": g.nelem, "state_rows": u.shape[0], "itemsize": u.element_size()}
    return {
        "pref_limit": (pref_limit, sh),
        "face_pass": (lambda: solver.p1_face_pass(sy, g, um),
                      dict(sh, face_rows=u.shape[0])),
    }
