"""The port's control layer against quinoa_tpu's: deck parser, typed
config and the solver builder.

Inline decks (the reference decks are not in this tree) cover every
scheme, pde, problem and BC keyword, pref/tolref, the amr block,
partitioning, diagnostics and field_output/plotvar:

- parse_deck trees are equal;
- dataclasses.asdict(load_inciter(deck)) is equal;
- every problem a deck can name builds the same problem (its dataclass
  fields) in both packages, a compflow deck with stray parameters too;
- each build_inciter branch (DiagCG, ALECG, multimat dg and dgp1, DG dg,
  p0p1, dgp1, dgp2, pdg) builds the same solver class with the same ndof,
  limiter, pref, evolve_ndof and BC codes per face (Dirichlet nodes for
  CG), and two steps agree within the tolerances the port's solver tests
  hold these solvers to: u atol 1e-11 of max(1, max|u|), dt rtol 1e-12
  (tests/test_torch_solver.py, test_torch_schemes.py), and for multimat
  DG(P1) u atol 1e-9 of max(1, max|u|) (its Superbee turns 1e-17 rhs
  differences into 3e-11 a step; tests/test_torch_multimat.py).

Float64 on the CPU: the JAX side runs under x64 (tests/conftest.py), the
port under torch.set_default_dtype(torch.float64), restored afterwards.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quinoa_tpu.control.config import build_inciter as j_build
from quinoa_tpu.control.config import load_inciter as j_load
from quinoa_tpu.control.qparser import parse_deck as j_parse
from quinoa_tpu.mesh import box_tet_mesh as j_box

from quinoa_tpu_torch.control import build_inciter as t_build
from quinoa_tpu_torch.control import load_inciter as t_load
from quinoa_tpu_torch.control import parse_deck as t_parse
from quinoa_tpu_torch.mesh import box_tet_mesh as t_box

U_ATOL = 1e-11
P1_STEP_ATOL = 1e-9   # multimat DG(P1), tests/test_torch_multimat.py
DT_RTOL = 1e-12


def _deck(body, scheme="dgp1", extra=""):
    return f"""
title "{scheme} deck"   # a comment
inciter
  nstep 2
  cfl 0.5
  scheme {scheme}
{extra}
{body}
  diagnostics interval 1 end
end
"""


#: decks for the parser and config: every scheme, pde, problem, BC
#: keyword and block the inciter reads
DECKS = {
    "diagcg_slot_cyl": """
title "Slotted cylinder, FCT"
inciter
  nstep 10 term 5.0 dt 1.0e-3 ttyi 2 ctau 0.75 fct false
  scheme diagcg
  transport
    physics advection problem slot_cyl depvar c ncomp 2
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  field_output interval 5 end
  diagnostics interval 2 format fixed precision 6 end
end
""",
    "alecg_vortical_flow": """
inciter
  nstep 5 cfl 0.5 t0 0.25
  scheme alecg
  compflow
    physics euler problem vortical_flow
    alpha 0.1 beta 1.0 p0 10.0
    material gamma 1.66666666666667 end pstiff 0.5 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  plotvar interval 3 end
  diagnostics interval 1 format default precision 8 end
end
""",
    "dg_sod": """
inciter
  nstep 100 dt 2.0e-3
  scheme dg flux laxfriedrichs
  compflow physics euler problem sod_shocktube
    material gamma 1.4 end end
    bc_extrapolate sideset 1 3 end end
    bc_sym sideset 2 4 5 6 end end
  end
end
""",
    "p0p1_sedov": _deck("""  compflow physics euler problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end""", "p0p1", "  limiter superbeep1"),
    "dgp1_weno_pref": _deck("""  compflow physics euler problem sedov_blastwave
    bc_sym sideset 1 2 3 4 5 6 end end
  end""", "dgp1", "  limiter wenop1 cweight 10.0\n  pref tolref 0.25 end"),
    "dgp2_taylor_green": _deck("""  compflow physics euler problem taylor_green
    material gamma 1.66666666666667 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end""", "dgp2"),
    "pdg_gauss_hump": _deck("""  transport physics advection problem gauss_hump ncomp 1
    bc_extrapolate sideset 1 end end
    bc_inlet sideset 2 end end
    bc_outlet sideset 3 end end
    bc_dirichlet sideset 4 5 6 end end
  end""", "pdg", "  limiter nolimiter"),
    "dg_cyl_advect": _deck("""  transport problem cyl_advect
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end""", "dg"),
    "diagcg_shear_diff": _deck("""  transport problem shear_diff ncomp 1
    u0 0.5 end lambda 1.5 0.25 end diffusivity 1e-3 2e-3 3e-3 end
    bc_dirichlet sideset 1 2 end end
  end""", "diagcg"),
    "dgp1_nl_energy_growth": _deck("""  compflow problem nl_energy_growth
    alpha 0.3 betax 1.5 betay 0.5 betaz 0.25 ce -0.5 kappa 0.7 r0 2.0
    material gamma 1.66666666666667 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end""", "dgp1", "  limiter superbeep1"),
    "alecg_rayleigh_taylor": _deck("""  compflow problem rayleigh_taylor
    alpha 1.0 betax 1.0 betay 1.0 betaz 1.0 p0 1.0 r0 1.0 kappa 1.0
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end""", "alecg"),
    "dg_rotated_sod": _deck("""  compflow problem rotated_sod_shocktube
    bc_extrapolate sideset 1 2 3 4 5 6 end end
  end""", "dg"),
    "diagcg_user_defined": _deck("""  compflow problem user_defined
    bc_sym sideset 1 2 3 4 5 6 end end
  end""", "diagcg"),
    "mm_interface_advection": _deck("""  multimat
    physics veleq problem interface_advection nmat 3
    material gamma 1.4 1.6 1.8 end cv 700.0 710.0 720.0 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end""", "dg"),
    "mm_sod_thinc": _deck("""  multimat
    problem sod_shocktube nmat 2 intsharp 1 intsharp_param 1.8
    bc_extrapolate sideset 1 2 end end
    bc_sym sideset 3 4 5 6 end end
  end""", "dgp1"),
    "mm_smooth_wave": _deck("""  multimat problem smooth_wave nmat 2
    bc_extrapolate sideset 1 2 3 4 5 6 end end
  end""", "dg"),
    "amr_partitioning": """
inciter
  nstep 4
  scheme dg
  amr
    t0ref true
    initial uniform
    initial coords
    coordref
      x- 0.1 x+ 0.9 y- 0.2 y+ 0.8
      z- 0.0 z+ 1.0
    end
    dtref true dtref_uniform false dtfreq 2 error hessian
    tol_refine 0.3 tol_derefine 0.1 maxlevels 2
    edgelist 0 1 2 3 end
  end
  partitioning algorithm rcb end
  compflow problem sod_shocktube
    bc_extrapolate sideset 1 end end
  end
end
""",
    "partitioning_unknown": """
inciter
  scheme diagcg
  partitioning algorithm zoltan end
  transport problem slot_cyl end
end
""",
    # stray alpha/beta/p0 lines: not fields of SedovBlastwave, ignored
    "stray_sedov": _deck("""  compflow physics euler problem sedov_blastwave
    alpha 0.3 beta 2.0 p0 5.0 kappa 0.2
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end""", "dgp1", "  limiter superbeep1"),
}


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_parse_deck_trees_equal(name):
    assert t_parse(DECKS[name]) == j_parse(DECKS[name])


@pytest.mark.parametrize("name", sorted(DECKS))
def test_load_inciter_equal(name):
    assert (dataclasses.asdict(t_load(DECKS[name]))
            == dataclasses.asdict(j_load(DECKS[name])))


def test_load_inciter_errors_match():
    for text in ('title "x"', "inciter scheme dg amr edgelist 1 2 3 end "
                 "end end"):
        with pytest.raises(ValueError) as je:
            j_load(text)
        with pytest.raises(ValueError) as te:
            t_load(text)
        assert str(te.value) == str(je.value)


def _fields(obj):
    """A problem's dataclass fields as plain Python values."""
    return {k: (_fields(v) if dataclasses.is_dataclass(v)
                else tuple(_fields(x) if dataclasses.is_dataclass(x) else x
                           for x in v) if isinstance(v, tuple) else v)
            for k, v in ((f.name, getattr(obj, f.name))
                         for f in dataclasses.fields(obj))}


#: the decks that build without the amr block
BUILDABLE = sorted(k for k in DECKS if not k.startswith(("amr", "partit")))


@pytest.mark.parametrize("name", BUILDABLE)
def test_build_inciter_problem_equal(name, f64):
    """Every problem the decks name (stray parameters included) builds
    with the JAX problem's dataclass fields, equation of state included."""
    js, _ = j_build(j_load(DECKS[name]), j_box(2, 2, 2))
    ts, _ = t_build(t_load(DECKS[name]), t_box(2, 2, 2), device="cpu")
    jp, tp = js.system.problem, ts.system.problem
    assert type(tp).__name__ == type(jp).__name__
    tf, jf = _fields(tp), _fields(jp)
    # the port's problems carry one field of their own: `steady`, which
    # lets its solvers evaluate a time-independent source once
    assert set(tf) - set(jf) <= {"steady"}
    assert {k: tf[k] for k in jf} == jf


#: one deck per build_inciter branch: (deck, box lo, box hi)
UNIT = ((0.0, 0.0, 0.0), (1.0, 1.0, 0.5))
BRANCHES = {
    "diagcg": (DECKS["diagcg_slot_cyl"], *UNIT),
    "alecg": (DECKS["alecg_vortical_flow"], (-0.5, -0.5, -0.5),
              (0.5, 0.5, 0.5)),
    "mm_dg": (DECKS["mm_interface_advection"], *UNIT),
    "mm_dgp1": (DECKS["mm_sod_thinc"], (0.0, 0.0, 0.0), (1.0, 0.5, 0.5)),
    "dg": (DECKS["dg_sod"], (0.0, 0.0, 0.0), (1.0, 0.5, 0.5)),
    "p0p1": (DECKS["p0p1_sedov"], (0.0, 0.0, 0.0), (0.4, 0.4, 0.2)),
    "dgp1": (DECKS["stray_sedov"], (0.0, 0.0, 0.0), (0.4, 0.4, 0.2)),
    "dgp2": (DECKS["dgp2_taylor_green"], *UNIT),
    "pdg": (DECKS["pdg_gauss_hump"], *UNIT),
}


def _close(a, b, atol):
    """u atol of max(1, max|u|), t and dt rtol 1e-12, it equal."""
    want = np.asarray(a.u)
    np.testing.assert_allclose(b.u.numpy(), want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))
    for k in ("t", "dt"):
        assert np.isclose(float(getattr(b, k)), float(getattr(a, k)),
                          rtol=DT_RTOL, atol=0), k
    assert int(b.it) == int(a.it)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_build_inciter_branch_matches_jax(branch, f64):
    deck, lo, hi = BRANCHES[branch]
    cfg_j, cfg_t = j_load(deck), t_load(deck)
    js, jd = j_build(cfg_j, j_box(4, 4, 2, lo=lo, hi=hi))
    ts, td = t_build(cfg_t, t_box(4, 4, 2, lo=lo, hi=hi), device="cpu")
    assert type(ts).__name__ == type(js).__name__
    assert type(td).__name__ == type(jd).__name__
    assert ts.geom.dtype == torch.float64
    assert ts.geom.device == torch.device("cpu")
    if hasattr(js.geom, "ndof"):
        assert ts.geom.ndof == js.geom.ndof
        np.testing.assert_array_equal(ts.geom.bctype.numpy(),
                                      np.asarray(js.geom.bctype))
        for k in ("limiter", "pref", "evolve_ndof", "tolref", "cweight"):
            assert getattr(ts, k, None) == getattr(js, k, None), k
    else:
        bc = getattr(ts, "bcmask", None)
        if bc is None:   # ALECG: the pinned node list
            np.testing.assert_array_equal(ts.bidx.numpy(),
                                          np.flatnonzero(
                                              np.asarray(js.bcmask)[0]))
        else:
            np.testing.assert_array_equal(bc.numpy(), np.asarray(js.bcmask))
    a = js.initial_state(t0=cfg_j.t0)
    b = ts.initial_state(t0=cfg_t.t0)
    for _ in range(2):
        a, b = js.step(a), ts.step(b)
        _close(a, b, P1_STEP_ATOL if branch == "mm_dgp1" else U_ATOL)
    if hasattr(a, "ndofel"):
        np.testing.assert_array_equal(b.ndofel.numpy(), np.asarray(a.ndofel))


def test_build_inciter_dtype_follows_torch_default():
    """dtype None is torch's default float (jax's default float is the
    JAX builders' default); an explicit dtype wins."""
    cfg = t_load(DECKS["p0p1_sedov"])
    mesh = t_box(2, 2, 1)
    s, _ = t_build(cfg, mesh, device="cpu")
    assert s.geom.dtype == torch.get_default_dtype()
    s, _ = t_build(cfg, mesh, dtype=torch.float64, device="cpu")
    assert s.initial_state().u.dtype == torch.float64


def test_build_inciter_refuses_what_jax_refuses(f64):
    for text, err in ((_deck("  multimat problem sod_shocktube end", "pdg"),
                       "multimat supports"),
                      (_deck("  multimat problem nope end", "dg"),
                       "unknown multimat problem"),
                      (_deck("  compflow problem sod_shocktube end", "cg"),
                       "unknown scheme")):
        for load, build, mesh in ((j_load, j_build, j_box(2, 2, 1)),
                                  (t_load, t_build, t_box(2, 2, 1))):
            kw = {"device": "cpu"} if build is t_build else {}
            with pytest.raises(ValueError, match=err):
                build(load(text), mesh, **kw)
