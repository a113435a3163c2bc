"""The port's DiagCG + FCT against quinoa_tpu's: the plain versions of K10
node_gather and K11 node_assemble against the JAX package's XLA gather and
assemblies and its Pallas window kernels (B13 gather_nodes_window, B14
assemble_max_window, B7's assemble_add_window) in interpret mode, the
Taylor-Galerkin rhs of both systems, every FCT method, one
diagcg_advance, and short DiagCGSolver runs.

Float64 on the CPU; inputs are made with numpy from a seed and handed to
both packages.  Tolerances:
- gathers and max-assemblies are exact (copies and maxima, no
  arithmetic); sum-assemblies 1e-14 relative (the same slot-level order;
  the window kernels sum through one-hot matmuls);
- rhs contributions and FCT methods 1e-12 of their largest entry (the
  same expressions; XLA may contract or reorder a few of them);
- solvers: u atol 1e-11 and dt rtol 1e-12, the JAX package's own two-step
  solver tolerance (tests/test_dg.py), and conservation to 1e-12 as
  tests/test_diagcg_transport.py holds the JAX package to it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.fct import FCT as JFCT
from quinoa_tpu.inciter import DiagCGSolver as JSolver
from quinoa_tpu.inciter.diagcg import diagcg_advance as j_advance
from quinoa_tpu.inciter.diagnostics import Diagnostics as JDiag
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import first_touch_node_reorder as j_first_touch
from quinoa_tpu.mesh.reorder import hilbert_element_reorder as j_hilbert
from quinoa_tpu.ops.assembly import assemble_add as j_assemble_add
from quinoa_tpu.ops.assembly import assemble_add_max as j_assemble_add_max
from quinoa_tpu.ops.assembly import assemble_max as j_assemble_max
from quinoa_tpu.ops.assembly import assemble_min as j_assemble_min
from quinoa_tpu.ops.assembly import gather_nodes as j_gather_nodes
from quinoa_tpu.ops.node_window import (assemble_add_window,
                                        assemble_max_window, build_node_plan,
                                        gather_nodes_window)
from quinoa_tpu.pde.cg import CGTransport as JTransport
from quinoa_tpu.pde.cg import make_cggeom as j_make_cggeom
from quinoa_tpu.pde.cg_compflow import CGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SlotCyl as JSlotCyl
from quinoa_tpu.pde.problems import VorticalFlow as JVortical

from quinoa_tpu_torch import kernels
from quinoa_tpu_torch.fct import FCT
from quinoa_tpu_torch.inciter import DiagCGSolver, Diagnostics, diagcg_advance
from quinoa_tpu_torch.ops.assembly import assemble_min, build_nsup
from quinoa_tpu_torch.ops.node_window import (node_assemble,
                                              node_assemble_plain,
                                              node_gather, node_gather_plain)
from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

SUM_RTOL = 1e-14
REL = 1e-12
U_ATOL = 1e-11
DT_RTOL = 1e-12

#: (mesh kwargs, system pair, cfl, solver kwargs): SlotCyl on
#: tests/test_diagcg_transport.py's box, VorticalFlow on
#: tests/test_cg_compflow.py's
RUNS = {
    "slotcyl": (dict(nx=16, ny=16, nz=4, hi=(1.0, 1.0, 0.25)), "slotcyl",
                0.8, {}),
    "slotcyl_nofct": (dict(nx=16, ny=16, nz=4, hi=(1.0, 1.0, 0.25)),
                      "slotcyl", 0.8, {"fct": False}),
    "slotcyl_const_dt": (dict(nx=16, ny=16, nz=4, hi=(1.0, 1.0, 0.25)),
                         "slotcyl", 0.8, {"const_dt": 2e-3}),
    "vortical": (dict(nx=6, ny=6, nz=6, lo=(-0.5, -0.5, -0.5),
                      hi=(0.5, 0.5, 0.5)), "vortical", 0.5, {}),
}


def _systems(name):
    if name == "slotcyl":
        return JTransport(JSlotCyl()), CGTransport(SlotCyl())
    return JCompFlow(JVortical()), CGCompFlow(VorticalFlow())


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def window_mesh():
    """tests/test_mesh.py's window mesh and its B13/B14 plan (W = 128)."""
    mesh = box_tet_mesh(5, 4, 3, hi=(1.0, 0.8, 0.6))
    mesh, _ = j_hilbert(mesh)
    mesh, _ = j_first_touch(mesh)
    plan = build_node_plan(mesh.inpoel, mesh.nnode, TF=128, W=128,
                           dtype=np.float64)
    nsup, _ = build_nsup(mesh.inpoel, mesh.nnode)
    return mesh, plan, nsup


@pytest.mark.parametrize("rows", [1, 2, 5])
def test_node_gather_matches_jax(window_mesh, rows):
    """K10's plain version equals gather_nodes and the B13 window kernel
    (interpret mode) exactly."""
    mesh, plan, _ = window_mesh
    U = np.random.default_rng(7).normal(size=(rows, mesh.nnode))
    inpoelT = np.ascontiguousarray(mesh.inpoel.T)
    got = node_gather_plain(_t(U), torch.from_numpy(inpoelT))
    assert got.shape == (4, rows, mesh.nelem)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_gather_nodes(jnp.asarray(U),
                                               jnp.asarray(inpoelT))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(gather_nodes_window(plan, jnp.asarray(U),
                                                    interpret=True)))
    np.testing.assert_array_equal(
        node_gather(_t(U), torch.from_numpy(inpoelT)).numpy(), got.numpy())


@pytest.mark.parametrize("rows", [1, 2, 10])
def test_node_assemble_sum_rows_match_jax(window_mesh, rows):
    """K11's sum rows against assemble_add and the windowed B7 sum
    (interpret mode), 1e-14."""
    mesh, plan, nsup = window_mesh
    x = np.random.default_rng(8).normal(size=(4, rows, mesh.nelem))
    got = node_assemble_plain(_t(x), None, torch.from_numpy(nsup))
    assert got.shape == (rows, mesh.nnode)
    _close(got, j_assemble_add(jnp.asarray(x), jnp.asarray(nsup)),
           SUM_RTOL)
    _close(got, assemble_add_window(plan, jnp.asarray(x), interpret=True),
           SUM_RTOL)


@pytest.mark.parametrize("corners", [4, 1])
def test_node_assemble_max_rows_match_jax(window_mesh, corners):
    """K11's max rows against assemble_max, the B14 window kernel
    (interpret mode) and assemble_add_max, exactly; one row per element
    (corners = 1) equals its broadcast to the four corners."""
    mesh, plan, nsup = window_mesh
    rng = np.random.default_rng(9)
    xm = rng.normal(size=(corners, 4, mesh.nelem))
    xa = rng.normal(size=(4, 2, mesh.nelem))
    x4 = jnp.asarray(np.broadcast_to(xm, (4, 4, mesh.nelem)))
    ns = torch.from_numpy(nsup)
    got = node_assemble_plain(None, _t(xm), ns)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_assemble_max(x4, jnp.asarray(nsup))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(assemble_max_window(plan, x4,
                                                    interpret=True)))
    both = node_assemble_plain(_t(xa), _t(xm), ns)
    ja, jm = j_assemble_add_max(jnp.asarray(xa), x4, jnp.asarray(nsup))
    np.testing.assert_array_equal(both[2:].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(both[:2].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(both[2:].numpy(), got.numpy())


#: the K11 calls of a DiagCG + FCT step (inciter/diagcg.py), as sum rows
#: and max rows (one row per element) per component: the rhs + diffusion
#: sums, the P sums + Q maxima and the limited A sums
K11_CALLS = {"rhs+diffusion": (2, 0), "P+Q": (2, 2), "limited A": (1, 0)}


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("call", list(K11_CALLS))
def test_node_assemble_path_instances_bitwise(window_mesh, C, call):
    """K11's plain version at every instance a DiagCG + FCT step launches,
    (2C), (2C + 2C, one max row per element) and (C) rows at C = 1
    (diagcg) and 5 (diagcg_cf), equals the JAX package's assemble_add, or
    its assemble_add_max of the element rows broadcast to the four
    corners, bit for bit in float64.  The mesh has nodes with fewer slots
    than D (pad slots); a NaN in one element's max row makes exactly its
    4 nodes' maxima NaN."""
    mesh, _, nsup = window_mesh
    E = mesh.nelem
    assert (nsup == 4 * E).any()
    fa, fm = K11_CALLS[call]
    rng = np.random.default_rng(30 + C)
    xa = rng.normal(size=(4, fa * C, E))
    xm = rng.normal(size=(1, fm * C, E)) if fm else None
    ns = torch.from_numpy(nsup)
    if xm is None:
        got = node_assemble_plain(_t(xa), None, ns).numpy()
        want = np.asarray(j_assemble_add(jnp.asarray(xa), jnp.asarray(nsup)))
    else:
        e0 = E // 2
        xm[0, -1, e0] = np.nan
        got = node_assemble_plain(_t(xa), _t(xm), ns).numpy()
        x4 = jnp.asarray(np.broadcast_to(xm, (4,) + xm.shape[1:]))
        ja, jm = j_assemble_add_max(jnp.asarray(xa), x4, jnp.asarray(nsup))
        want = np.concatenate([np.asarray(ja), np.asarray(jm)])
        nan = np.isnan(got)
        assert int(nan.sum()) == 4
        assert set(np.nonzero(nan[-1])[0]) == set(mesh.inpoel[e0])
    assert got.shape == ((fa + fm) * C, mesh.nnode)
    np.testing.assert_array_equal(got, want)


def test_node_assemble_pads_and_nan():
    """A node that no slot touches reads 0 in a sum row and finfo.min in a
    max row; a NaN slot makes its nodes' maxima NaN (torch.maximum, as
    jnp.maximum); assemble_min matches the JAX package's."""
    mesh = box_tet_mesh(2, 2, 1)
    N = mesh.nnode + 1                       # the last node is isolated
    nsup, _ = build_nsup(mesh.inpoel, N)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 3, mesh.nelem))
    x[2, 1, 5] = np.nan
    ns = torch.from_numpy(nsup)
    out = node_assemble(_t(x), _t(x), ns)
    assert (out[:3, -1] == 0).all()
    assert (out[3:, -1] == torch.finfo(torch.float64).min).all()
    nan_node = int(mesh.inpoel[5, 2])
    assert torch.isnan(out[3 + 1, nan_node])
    assert int(torch.isnan(out[3:]).sum()) == 1
    want = np.asarray(j_assemble_max(jnp.asarray(x), jnp.asarray(nsup)))
    np.testing.assert_array_equal(out[3:].numpy(), want)
    np.testing.assert_array_equal(
        assemble_min(_t(x), ns).numpy(),
        np.asarray(j_assemble_min(jnp.asarray(x), jnp.asarray(nsup))))


@pytest.fixture(scope="module", params=["slotcyl", "vortical"])
def pair(request):
    """Both packages' geometry and system on the same ordered mesh, with a
    seeded state u, a perturbed low-order state ul and a Dirichlet mask."""
    meshkw = RUNS[request.param][0]
    mesh = box_tet_mesh(**meshkw)
    mesh, _ = j_hilbert(mesh)
    mesh, _ = j_first_touch(mesh)
    jsys, tsys = _systems(request.param)
    jg, tg = j_make_cggeom(mesh), make_cggeom(mesh, device="cpu")
    rng = np.random.default_rng(12)
    u0 = np.asarray(jsys.initialize(jg.coords, 0.0))
    u = u0 * (1.0 + 0.05 * rng.random(u0.shape))
    ul = u + 0.01 * rng.standard_normal(u.shape) * np.abs(u).max(axis=1,
                                                                keepdims=True)
    bcmask = np.zeros_like(u)
    bcmask[:, mesh.all_bnodes()] = 1.0
    return request.param, jsys, tsys, jg, tg, u, ul, bcmask


def test_rhs_contrib_matches(pair):
    """The Taylor-Galerkin rhs contributions (4, C, E) and the assembled
    rhs of both systems, at t = 0.3, dt = 1e-2."""
    _, jsys, tsys, jg, tg, u, _, _ = pair
    un = j_gather_nodes(jnp.asarray(u), jg.inpoelT)
    t, dt = 0.3, 1e-2
    want = jsys.rhs_contrib(t, dt, jg, jnp.asarray(u), un)
    got = tsys.rhs_contrib(_t(t), _t(dt), tg, _t(u), _t(un))
    _close(got, want)
    _close(tsys.rhs(_t(t), _t(dt), tg, _t(u)),
           jsys.rhs(t, dt, jg, jnp.asarray(u)))


FCT_METHODS = ["diff_contrib", "diff", "aec_contrib", "aec", "alw_contrib",
               "alw_contrib_gathered", "alw", "lim"]


@pytest.mark.parametrize("method", FCT_METHODS)
def test_fct_method_matches(pair, method):
    """Each FCT method on the same inputs in both packages; lim is fed the
    JAX package's aec, P and Q."""
    _, _, _, jg, tg, u, ul, bcmask = pair
    jf, tf = JFCT(ctau=1.0), FCT(ctau=1.0)
    ju, jul, jbc = jnp.asarray(u), jnp.asarray(ul), jnp.asarray(bcmask)
    un = j_gather_nodes(ju, jg.inpoelT)
    uln = j_gather_nodes(jul, jg.inpoelT)
    du = jul - ju
    if method == "diff_contrib":
        pairs = [(tf.diff_contrib(tg, _t(un)), jf.diff_contrib(jg, un))]
    elif method == "diff":
        pairs = [(tf.diff(tg, _t(u)), jf.diff(jg, ju))]
    elif method == "aec_contrib":
        pairs = [(tf.aec_contrib(tg, _t(du), _t(u), _t(bcmask)),
                  jf.aec_contrib(jg, du, ju, jbc))]
    elif method == "aec":
        pairs = list(zip(tf.aec(tg, _t(du), _t(u), _t(bcmask)),
                         jf.aec(jg, du, ju, jbc)))
    elif method == "alw_contrib":
        pairs = [(tf.alw_contrib(tg, _t(u), _t(ul)),
                  jf.alw_contrib(jg, ju, jul))]
    elif method == "alw_contrib_gathered":
        pairs = [(tf.alw_contrib(tg, _t(u), _t(ul), un=_t(un), uln=_t(uln)),
                  jf.alw_contrib(jg, ju, jul, un=un, uln=uln))]
    elif method == "alw":
        pairs = [(tf.alw(tg, _t(u), _t(ul)), jf.alw(jg, ju, jul))]
    else:
        aec, P = jf.aec(jg, du, ju, jbc)
        Q = jf.alw(jg, ju, jul)
        pairs = [(tf.lim(tg, _t(aec), _t(P), _t(Q), _t(ul)),
                  jf.lim(jg, aec, P, Q, jul))]
    for got, want in pairs:
        _close(got, want)


def test_diagcg_advance_matches(pair):
    """One diagcg_advance (identity combine hooks) from the seeded state."""
    name, jsys, tsys, jg, tg, u, _, bcmask = pair
    jlhs = JSolver(jsys, jg).lhs
    dt = 1e-3
    want = j_advance(jsys, JFCT(), True, jg, jlhs, jnp.asarray(bcmask),
                     jnp.asarray(u), 0.1, dt)
    got = diagcg_advance(tsys, FCT(), True, tg, _t(jlhs), _t(bcmask), _t(u),
                         _t(0.1), _t(dt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=U_ATOL * max(1.0, np.abs(u).max()))


@pytest.mark.parametrize("run", list(RUNS))
def test_solver_matches_jax(run):
    """Three steps of DiagCGSolver against quinoa_tpu's, every boundary
    node pinned; nsteps(3) repeats the three steps, and the diagnostics of
    the last state match too."""
    meshkw, system, cfl, kw = RUNS[run]
    mesh = box_tet_mesh(**meshkw)
    jsys, tsys = _systems(system)
    js = JSolver(jsys, j_make_cggeom(mesh), cfl=cfl,
                 bcnodes=mesh.all_bnodes(), **kw)
    ts = DiagCGSolver(tsys, make_cggeom(mesh, device="cpu"), cfl=cfl,
                      bcnodes=mesh.all_bnodes(), **kw)
    a, b = js.initial_state(), ts.initial_state()
    np.testing.assert_array_equal(b.u.numpy(), np.asarray(a.u))
    for n in range(3):
        a, b = js.step(a), ts.step(b)
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=U_ATOL)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL, atol=0)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL, atol=0)
        assert int(b.it) == int(a.it) == n + 1
    np.testing.assert_array_equal(ts.nsteps(ts.initial_state(), 3).u.numpy(),
                                  b.u.numpy())
    np.testing.assert_allclose(ts.compute_dt(b.u).numpy(),
                               np.asarray(js.compute_dt(a.u)), rtol=DT_RTOL)
    got = Diagnostics(ts.system, ts.geom).compute(b)
    want = JDiag(js.system, js.geom).compute(a)
    assert got.it == want.it
    for x, y in ((got.l2sol, want.l2sol), (got.l2err, want.l2err),
                 (got.linferr, want.linferr)):
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-14)


def test_conservative_without_bc():
    """Without Dirichlet nodes TG + FCT conserves sum(u vol) to 1e-12."""
    mesh = box_tet_mesh(10, 10, 3, hi=(1.0, 1.0, 0.3))
    geom = make_cggeom(mesh, device="cpu")
    s = DiagCGSolver(CGTransport(SlotCyl()), geom, cfl=0.5, bcnodes=None)
    st = s.initial_state()
    m0 = float((st.u[0] * geom.vol).sum())
    st = s.nsteps(st, 10)
    m = float((st.u[0] * geom.vol).sum())
    assert abs(m - m0) / abs(m0) < 1e-12


def test_fct_monotone():
    """FCT keeps SlotCyl within its initial bounds (1e-10) over 20 steps."""
    mesh = box_tet_mesh(16, 16, 4, hi=(1.0, 1.0, 0.25))
    s = DiagCGSolver(CGTransport(SlotCyl()), make_cggeom(mesh, device="cpu"),
                     cfl=0.8, bcnodes=mesh.all_bnodes())
    u0 = s.initial_state().u
    u = s.nsteps(s.initial_state(), 20).u
    assert bool(torch.isfinite(u).all())
    assert float(u.min()) >= float(u0.min()) - 1e-10
    assert float(u.max()) <= float(u0.max()) + 1e-10


def test_cpu_tensors_launch_no_kernel():
    """A DiagCG step of each flavour on CPU tensors runs the plain
    versions (no launch), and the K10/K11 wrappers refuse CPU tensors."""
    kernels.reset_launches()
    for name in ("slotcyl", "vortical"):
        meshkw, system, cfl, _ = RUNS[name]
        mesh = box_tet_mesh(**dict(meshkw, nx=4, ny=4, nz=3))
        s = DiagCGSolver(_systems(system)[1],
                         make_cggeom(mesh, device="cpu"), cfl=cfl,
                         bcnodes=mesh.all_bnodes())
        s.nsteps(s.initial_state(), 1)
        g = s.geom
    assert set(kernels.launches.values()) == {0}
    U = torch.zeros((2, g.nnode), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.node_gather(U, g.inpoelT)
    x = torch.zeros((4, 2, g.nelem), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.node_assemble(x, None, g.nsup)
    assert set(kernels.launches.values()) == {0}
