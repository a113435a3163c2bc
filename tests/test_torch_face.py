"""The port's face pass (kernels K2 + K3, plain versions) against
quinoa_tpu: the near/far Pallas face pass run in interpret mode through
dg_rhs with an explicit accumulation plan, and the XLA dg_rhs + dg_dt.

Float64 on the CPU on the 5x5x4 box of the JAX package's own fused-pass
test (both near and far streams live at TF=W=128).  Tolerances are the
ones the JAX package holds its fused face pass to: rhs atol 1e-11, dt
rtol 1e-12 (tests/test_dg.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.pde.dg import BC_SYMMETRY, build_dggeom
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_dt_from_delt as j_dt_from_delt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.ops.face_fused import face_flux_plain, fused_face_pass
from quinoa_tpu_torch.ops.nbr_bounds import volume_rhs_plain
from quinoa_tpu_torch.pde.dg import dg_dt, dg_dt_from_delt, dg_rhs
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov

RHS_ATOL = 1e-11
DT_RTOL = 1e-12


@pytest.fixture(scope="module")
def case():
    mesh = box_tet_mesh(5, 5, 4, hi=(0.5, 0.5, 0.4))
    # mixed boundary codes: symmetry walls plus extrapolate faces
    bc = {i: BC_SYMMETRY for i in range(1, 5)}
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    tg = convert.geom_from_arrays(arrays)
    rng = np.random.default_rng(3)
    E, K = jg.nelem, 4
    U0 = np.zeros((5 * K, E))
    U0[0] = 1.0 + 0.05 * rng.random(E)
    U0[4 * K] = 2.5 + 0.05 * rng.random(E)
    U0[K] = 0.1 * rng.random(E)
    for ck in range(5 * K):
        if ck % K:
            U0[ck] = 0.01 * rng.random(E)
    tsys = TCompFlow(TSedov())
    tU = torch.as_tensor(U0)
    r, delt = fused_face_pass(tsys, tg, tU,
                              vol_rhs=volume_rhs_plain(tsys, tg, tU))
    return jg, tg, U0, r.numpy(), delt


def test_face_pass_matches_pallas_nearfar(case):
    """rhs and dt against dg_rhs through the Pallas near/far kernels
    (interpret mode, want_charvel=True)."""
    jg, tg, U0, r, delt = case
    system = JCompFlow(JSedov())
    plan = build_accum_plan(jg, TF=128, W=128)
    assert plan.fused.Fn > 0 and plan.fused.Ff > 0
    r_j, delt_j = jax.jit(
        lambda g, p, u: j_dg_rhs(system, g, u, None, 0.0, accum_plan=p,
                                 face_gp=False, want_charvel=True)
    )(jg, plan, jnp.asarray(U0))
    np.testing.assert_allclose(r, np.asarray(r_j), rtol=0, atol=RHS_ATOL)
    assert np.isclose(float(dg_dt_from_delt(tg, delt)),
                      float(j_dt_from_delt(jg, delt_j)), rtol=DT_RTOL)


def test_face_pass_matches_xla_rhs_and_dt(case):
    """rhs and dt against the XLA formulation (no plan), and the port's
    plain dg_rhs / dg_dt against the same."""
    jg, tg, U0, r, delt = case
    system = JCompFlow(JSedov())
    U = jnp.asarray(U0)
    r_x = np.asarray(jax.jit(lambda g, u: j_dg_rhs(
        system, g, u, None, 0.0, face_gp=False))(jg, U))
    dt_x = float(j_dg_dt(system, jg, U, None))
    np.testing.assert_allclose(r, r_x, rtol=0, atol=RHS_ATOL)
    assert np.isclose(float(dg_dt_from_delt(tg, delt)), dt_x, rtol=DT_RTOL)

    tsys = TCompFlow(TSedov())
    tU = torch.as_tensor(U0)
    np.testing.assert_allclose(dg_rhs(tsys, tg, tU).numpy(), r_x, rtol=0,
                               atol=RHS_ATOL)
    assert np.isclose(float(dg_dt(tsys, tg, tU)), dt_x, rtol=DT_RTOL)


def test_pad_faces_contribute_nothing(case):
    """fmask = 0 faces (padding) evaluate a finite unit state whose zero
    weight removes them, even where the gathered state is all zeros
    (0/0 in the flux), as the Pallas kernels do (face_fused.py:501-503)."""
    _, tg, U0, _, _ = case
    pad = torch.zeros(tg.nface, dtype=torch.bool)
    pad[::7] = True
    g = dataclasses.replace(tg, fmask=torch.where(pad, 0.0, tg.fmask))
    U = torch.as_tensor(U0).clone()
    U[:, g.el[pad].long()] = 0.0     # left states of pad faces: 0/0
    cL, cR, mx = face_flux_plain(TCompFlow(TSedov()), g, U)
    for t in (cL[:, pad], cR[:, pad], mx[pad]):
        assert bool((t == 0).all())
