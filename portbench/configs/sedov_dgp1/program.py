"""The port's public entries of the per-layer operations on sedov_dgp1's
solver (quinoa_tpu_torch.inciter.dg.DGSolver at DG(P1) with Superbee):
the face pass (K12 + K13) and the limit-and-volume stage (K1), each with
the shapes work/<operation>.py counts its bytes from."""


def ops(solver, state):
    from quinoa_tpu_torch.ops.nbr_bounds import superbee_limit_window

    g, sy, u = solver.geom, solver.system, state.u
    sh = {"nelem": g.nelem, "state_rows": u.shape[0], "itemsize": u.element_size()}
    return {
        "face_pass": (lambda: solver.p1_face_pass(sy, g, u),
                      dict(sh, face_rows=u.shape[0])),
        "limit_volume": (lambda: superbee_limit_window(g, u, sy), sh),
    }
