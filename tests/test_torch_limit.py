"""The port's limit + volume pass (kernel K1's plain version) against
quinoa_tpu: the Pallas superbee_limit_window(emit_vol=True) kernel run in
interpret mode, and the XLA formulation superbee_p1 + dg_rhs's volume
integral.

Float64 on the CPU, one kernel call on a 6x6x4 box (the size at which the
JAX package's own test keeps the far-neighbour path live at W=128).  The
state is made with numpy from a seed and handed to both packages; the
geometry goes through convert.py, so both see identical tables.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.nbr_bounds import build_bounds_plan
from quinoa_tpu.ops.nbr_bounds import superbee_limit_window as j_window
from quinoa_tpu.pde.dg import BC_SYMMETRY, build_dggeom, dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.limiter import superbee_p1 as j_superbee_p1
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.ops.nbr_bounds import superbee_limit_window
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.limiter import superbee_p1
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov

C, K = 5, 4
#: limited state: min/max/select plus a 4-term sum (the JAX package holds
#: its own fused limit kernel to this, tests/test_dg.py)
ATOL_ULIM = 1e-13
#: volume integral: 5-point flux sums, |Rv| up to ~1e-1
ATOL_RV = 1e-13


def _arrays(g):
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name != "tables"}
    out["tables"] = dict(g.tables)
    return out


@pytest.fixture(scope="module")
def case():
    mesh = box_tet_mesh(6, 6, 4, hi=(0.6, 0.6, 0.4))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    rng = np.random.default_rng(5)
    U0 = rng.standard_normal((C * K, jg.nelem)) * 0.1
    U0[[c * K for c in range(C)]] += 2.0
    tU = torch.as_tensor(U0, dtype=torch.float64)
    ulim, rv = superbee_limit_window(tg, tU, TCompFlow(TSedov()))
    return jg, tg, U0, ulim.numpy(), rv.numpy()


def test_limit_window_matches_pallas_kernel(case):
    """Against the fused Pallas limit + volume kernel (interpret mode)."""
    jg, _, U0, ulim, rv = case
    plan = build_bounds_plan(jg, W=128)
    assert plan.nef > 0  # far neighbours live
    jl, jrv = j_window(plan, jg, jnp.asarray(U0), C, interpret=True,
                       emit_vol=True, system=JCompFlow(JSedov()))
    assert not np.allclose(np.asarray(jl), U0)  # the limiter acted
    np.testing.assert_allclose(ulim, np.asarray(jl), rtol=0, atol=ATOL_ULIM)
    np.testing.assert_allclose(rv, np.asarray(jrv), rtol=0, atol=ATOL_RV)


def test_limit_window_matches_xla_formulation(case):
    """Against superbee_p1 (esuelT gather) and dg_rhs's einsum volume
    integral, which sums the quadrature in another order."""
    jg, tg, U0, ulim, rv = case
    system = JCompFlow(JSedov())
    jl = j_superbee_p1(jg, jnp.asarray(U0), None, C)
    np.testing.assert_allclose(ulim, np.asarray(jl), rtol=0, atol=ATOL_ULIM)
    np.testing.assert_allclose(
        superbee_p1(tg, torch.as_tensor(U0), None, C).numpy(),
        np.asarray(jl), rtol=0, atol=ATOL_ULIM)
    # dg_rhs with and without its volume term: the difference is the
    # XLA volume integral (face terms cancel to rounding)
    rhs = jax.jit(lambda g, u, v: dg_rhs(system, g, u, None, 0.0,
                                         face_gp=False, vol_rhs=v))
    full = rhs(jg, jl, None)
    faces = rhs(jg, jl, jnp.zeros_like(jl))
    np.testing.assert_allclose(rv, np.asarray(full - faces), rtol=0,
                               atol=1e-12)
