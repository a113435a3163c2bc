"""The port's public entries of the per-layer operations on mm_sod_dgp1's
solver (quinoa_tpu_torch.pde.multimat.MultiMatSolver at DG(P1)): the face
pass (ops/face_fused.py mm_face_pass: K14 + K13) and the limit-and-volume
stage (MultiMatSolver._limit, then pde/dg.py volume_rhs of the limited
state), each with the shapes work/<operation>.py counts its bytes from.
The face pass's output rows are the state's and the 3*nmat + 1 rows of
partial-pressure and velocity sums that the non-conservative terms read
(their first mode only)."""


def ops(solver, state):
    from quinoa_tpu_torch.ops.face_fused import mm_face_pass
    from quinoa_tpu_torch.pde.dg import volume_rhs

    g, sy, u, t = solver.geom, solver.system, state.u, state.t
    sh = {"nelem": g.nelem, "state_rows": u.shape[0], "itemsize": u.element_size()}
    return {
        "face_pass": (lambda: mm_face_pass(sy, g, u),
                      dict(sh, face_rows=u.shape[0] + 3 * sy.nmat + 1)),
        "limit_volume": (lambda: volume_rhs(sy, g, solver._limit(u), t), sh),
    }
