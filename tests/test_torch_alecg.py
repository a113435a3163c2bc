"""The port's ALECG against quinoa_tpu: first-touch node order, CG
geometry and edge tables, the nsup gather/assembly, SlotCyl (one and
three components) and VorticalFlow (with its manufactured source through
torch.func.jvp), K7's node velocity rows against the Pallas plan's
per-corner rows, the stage rhs of the kernels' plain versions (K7
alecg_vol, K8 alecg_edge, K9 cg_assemble) against the XLA formulation and
against the Pallas B9/B10 kernels in interpret mode, and the ALECG solver
against make_alecg.

Float64 on the CPU.  Meshes are Hilbert-element and first-touch-node
ordered as bench_alecg.py orders them; states are made with numpy from a
seed.  Tolerances:
- integer tables, the reorder and the velocity rows are exact; float
  geometry 1e-14 relative (the same float64 numpy code on both sides);
- problems and the manufactured source 1e-13 (the same closed forms;
  the source differs by the order of the two AD systems' jvp terms);
- the stage rhs 1e-13 of its largest entry against XLA (the same order,
  up to XLA's multiply-add contraction) and 1e-12 against the Pallas
  kernels (one-hot matmul windows sum in another order);
- solvers: the whole u to 1e-12 (absolute for SlotCyl, relative to
  max|u| for VorticalFlow) and dt rtol 1e-12, as tests/test_alecg_fused.py
  holds the JAX package's own kernels to its XLA path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.inciter.alecg import alecg_dissipation as j_dissipation
from quinoa_tpu.inciter.alecg import alecg_flux_rhs as j_flux_rhs
from quinoa_tpu.inciter.alecg import make_alecg as j_make_alecg
from quinoa_tpu.inciter.diagnostics import Diagnostics as JDiag
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import first_touch_node_reorder as j_first_touch
from quinoa_tpu.mesh.reorder import hilbert_element_reorder as j_hilbert
from quinoa_tpu.ops.alecg_fused import alecg_rhs_fused, build_alecg_fused_plan
from quinoa_tpu.ops.assembly import assemble_add as j_assemble_add
from quinoa_tpu.ops.assembly import gather_nodes as j_gather_nodes
from quinoa_tpu.pde.cg import CGTransport as JTransport
from quinoa_tpu.pde.cg import lumped_mass as j_lumped_mass
from quinoa_tpu.pde.cg_compflow import CGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SlotCyl as JSlotCyl
from quinoa_tpu.pde.problems import VorticalFlow as JVortical

from quinoa_tpu_torch import convert, kernels
from quinoa_tpu_torch.inciter.alecg import (alecg_dissipation,
                                            alecg_flux_rhs, make_alecg)
from quinoa_tpu_torch.inciter.diagnostics import Diagnostics
from quinoa_tpu_torch.mesh import (first_touch_node_reorder,
                                   hilbert_element_reorder)
from quinoa_tpu_torch.ops.alecg_fused import (alecg_edge_plain, alecg_rhs,
                                              alecg_vol_plain,
                                              cg_assemble_plain)
from quinoa_tpu_torch.ops.assembly import (assemble_add, build_nsup,
                                           gather_nodes)
from quinoa_tpu_torch.pde.cg import CGTransport, lumped_mass, make_cggeom
from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

F64 = torch.float64
GEOM_RTOL = 1e-14
PROB_ATOL = 1e-13
RHS_RTOL = 1e-13
PALLAS_RTOL = 1e-12
U_TOL = 1e-12
DT_RTOL = 1e-12

#: (mesh, system pair, cfl, steps): the meshes of tests/test_alecg_fused.py
#: (its SlotCyl and VorticalFlow parity runs), and SlotCyl with three
#: components (each the field phase-shifted, all with one velocity)
CASES = {
    "slotcyl": (dict(nx=10, ny=10, nz=5, hi=(1.0, 1.0, 0.5)),
                lambda: (JTransport(JSlotCyl()), CGTransport(SlotCyl())),
                0.8, 4),
    "slotcyl3": (dict(nx=10, ny=10, nz=5, hi=(1.0, 1.0, 0.5)),
                 lambda: (JTransport(JSlotCyl(ncomp=3)),
                          CGTransport(SlotCyl(ncomp=3))),
                 0.8, 2),
    "vortical": (dict(nx=8, ny=8, nz=8, lo=(-0.5, -0.5, -0.5),
                      hi=(0.5, 0.5, 0.5)),
                 lambda: (JCompFlow(JVortical()), CGCompFlow(VorticalFlow())),
                 0.6, 3),
}


def _ordered(nx, ny, nz, **kw):
    mesh = box_tet_mesh(nx, ny, nz, **kw)
    mesh, _ = j_hilbert(mesh)
    mesh, _ = j_first_touch(mesh)
    return mesh


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _state(rng, case, N):
    """A seeded nodal state (C, N): random scalar fields for transport,
    physical conservative states for compflow."""
    if case.startswith("slotcyl"):
        return rng.random((3 if case == "slotcyl3" else 1, N))
    rho = 0.5 + rng.random(N)
    vel = rng.standard_normal((3, N))
    p = 0.1 + rng.random(N)
    rE = p / (2.0 / 3.0) + 0.5 * rho * (vel ** 2).sum(0)
    return np.concatenate([rho[None], rho * vel, rE[None]])


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' solvers on the same ordered mesh."""
    meshkw, systems, cfl, nsteps = CASES[request.param]
    mesh = _ordered(**meshkw)
    jsys, tsys = systems()
    js = j_make_alecg(jsys, mesh, cfl=cfl, bcnodes=mesh.all_bnodes())
    ts = make_alecg(tsys, mesh, cfl=cfl, bcnodes=mesh.all_bnodes(),
                    device="cpu")
    return request.param, mesh, js, ts, nsteps


def test_first_touch_node_reorder_identical():
    """The same permutation, connectivity, coordinates and boundary sets
    as the JAX package's reorder, after the same Hilbert element order."""
    mesh = box_tet_mesh(5, 4, 3, lo=(-0.5, 0.0, 0.0))
    a, ea = j_hilbert(mesh)
    b, eb = hilbert_element_reorder(mesh)
    np.testing.assert_array_equal(ea, eb)
    a, pa = j_first_touch(a)
    b, pb = first_touch_node_reorder(b)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a.inpoel, b.inpoel)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.all_bnodes(), b.all_bnodes())
    assert sorted(a.bface) == sorted(b.bface)
    for k in a.bface:
        np.testing.assert_array_equal(a.bface[k], b.bface[k])


def test_cggeom_and_lumped_mass_match(case):
    """make_cggeom's fields (integers exact, floats 1e-14 relative), the
    lumped mass, and the convert.py round trip of the JAX geometry."""
    _, mesh, js, ts, _ = case
    jg, tg = js.geom, ts.geom
    assert tg.nnode == jg.nnode and tg.nelem == jg.nelem
    for name in ("inpoelT", "nsup"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    for name in ("coords", "J", "grad", "vol", "emask", "coords_n", "ctr"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=GEOM_RTOL, atol=0)
    np.testing.assert_allclose(lumped_mass(tg).numpy(),
                               np.asarray(j_lumped_mass(jg)),
                               rtol=GEOM_RTOL, atol=0)
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "plan"}
    back = convert.cg_geom_to_arrays(
        convert.cg_geom_from_arrays(arrays, device="cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, arrays[k])
    with pytest.raises(KeyError):
        convert.cg_geom_from_arrays({k: v for k, v in arrays.items()
                                     if k != "nsup"}, device="cpu")


def test_edge_tables_match(case):
    """Edges, ensup (exact), A and the endpoint coordinates (1e-14
    relative), and their convert.py round trip."""
    _, mesh, js, ts, _ = case
    je, te = js.edget, ts.edget
    np.testing.assert_array_equal(te.edges.numpy(), np.asarray(je.edges))
    np.testing.assert_array_equal(te.ensup.numpy(), np.asarray(je.ensup))
    for name in ("A", "xyz"):
        np.testing.assert_allclose(getattr(te, name).numpy(),
                                   np.asarray(getattr(je, name)),
                                   rtol=GEOM_RTOL, atol=0)
    arrays = {k: np.asarray(getattr(je, k))
              for k in ("edges", "A", "ensup", "xyz")}
    back = convert.edge_tables_to_arrays(
        convert.edge_tables_from_arrays(arrays, device="cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, arrays[k])


@pytest.mark.parametrize("slots", [4, 2])
def test_gather_and_assemble_exact(slots):
    """gather_nodes and assemble_add on seeded contributions: bit for bit
    (the same copies, and the same sums in the same slot order), for the
    element (4 slots) and edge (2 slots) tables; build_nsup's numpy path
    gives the native table."""
    mesh = _ordered(4, 3, 3)
    rng = np.random.default_rng(slots)
    if slots == 4:
        inc = mesh.inpoel
    else:
        from quinoa_tpu.mesh.derived import gen_inpoed

        inc = gen_inpoed(mesh.inpoel).astype(np.int32)
    nsup, D = build_nsup(inc, mesh.nnode)
    from quinoa_tpu.ops.assembly import build_nsup as j_build_nsup

    jn, jD = j_build_nsup(inc, mesh.nnode)
    assert D == jD
    np.testing.assert_array_equal(nsup, jn)
    contrib = rng.standard_normal((slots, 3, len(inc)))
    np.testing.assert_array_equal(
        assemble_add(_t(contrib), torch.from_numpy(nsup)).numpy(),
        np.asarray(j_assemble_add(jnp.asarray(contrib), jnp.asarray(nsup))))
    U = rng.standard_normal((3, mesh.nnode))
    inpoelT = np.ascontiguousarray(mesh.inpoel.T, np.int32)
    np.testing.assert_array_equal(
        gather_nodes(_t(U), torch.from_numpy(inpoelT)).numpy(),
        np.asarray(j_gather_nodes(jnp.asarray(U), jnp.asarray(inpoelT))))


@pytest.mark.parametrize("rows", [1, 5])
def test_cg_assemble_plain_bitwise_at_path_rows(rows):
    """K9's plain version at the ALECG paths' rows (1: alecg, 5:
    alecg_cf) equals the JAX package's assemble_add of cv at its four
    corners plus its assemble_add of [d, -d] over the edge slots, added as
    quinoa_tpu/inciter/alecg.py adds them, bit for bit in float64; both
    slot tables have nodes with fewer slots than D (pad slots)."""
    from quinoa_tpu.mesh.derived import gen_inpoed

    mesh = _ordered(4, 3, 3)
    edges = gen_inpoed(mesh.inpoel).astype(np.int32)
    E, nE = mesh.nelem, len(edges)
    nsup, _ = build_nsup(mesh.inpoel, mesh.nnode)
    ensup, _ = build_nsup(edges, mesh.nnode)
    assert (nsup == 4 * E).any() and (ensup == 2 * nE).any()
    rng = np.random.default_rng(40 + rows)
    cv = rng.standard_normal((rows, E))
    d = rng.standard_normal((rows, nE))
    got = cg_assemble_plain(_t(cv), _t(d), torch.from_numpy(nsup),
                            torch.from_numpy(ensup))
    vol = j_assemble_add(jnp.broadcast_to(jnp.asarray(cv), (4, rows, E)),
                         jnp.asarray(nsup))
    dis = j_assemble_add(jnp.stack([jnp.asarray(d), -jnp.asarray(d)]),
                         jnp.asarray(ensup))
    assert got.shape == (rows, mesh.nnode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(vol + dis))


def test_numpy_build_nsup_matches_native():
    """The port's numpy build_nsup builds the JAX package's native table
    (its numpy fallback where the library is not built), for element and
    edge slots."""
    from quinoa_tpu.mesh.derived import gen_inpoed as j_gen_inpoed
    from quinoa_tpu.ops.assembly import build_nsup as j_build_nsup

    mesh = _ordered(3, 3, 2)
    for inc in (mesh.inpoel, j_gen_inpoed(mesh.inpoel).astype(np.int32)):
        got, D = build_nsup(inc, mesh.nnode)
        want, D2 = j_build_nsup(inc, mesh.nnode)
        assert D == D2
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [0.0, 0.37, 2.9])
def test_slotcyl_matches(t):
    """SlotCyl velocity, solution and CGTransport's solinc (one and three
    components, the latter phase-shifted), float and 0-d tensor times,
    atol 1e-13."""
    rng = np.random.default_rng(3)
    xyz = rng.random((3, 400))
    for ncomp in (1, 3):
        j, p = JSlotCyl(ncomp=ncomp), SlotCyl(ncomp=ncomp)
        np.testing.assert_allclose(
            p.velocity(_t(xyz), t).numpy(),
            np.asarray(j.velocity(jnp.asarray(xyz), t)), rtol=0,
            atol=PROB_ATOL)
        want = np.asarray(j.solution(jnp.asarray(xyz), jnp.asarray(t)))
        for tt in (t, torch.tensor(t, dtype=F64)):
            np.testing.assert_allclose(p.solution(_t(xyz), tt).numpy(),
                                       want, rtol=0, atol=PROB_ATOL)
        assert 0.0 < want.max() <= 0.6
        np.testing.assert_allclose(
            CGTransport(p).solinc(_t(xyz), t, 0.3).numpy(),
            np.asarray(JTransport(j).solinc(jnp.asarray(xyz), t, 0.3)),
            rtol=0, atol=PROB_ATOL)


def test_vortical_flow_and_source_match():
    """VorticalFlow's solution and its manufactured source S = dU/dt +
    div F(U) through torch.func.jvp against jax.jvp, atol 1e-13; the
    source of a steady problem is the same bit for bit at every t (the
    solver evaluates it once)."""
    rng = np.random.default_rng(4)
    xyz = rng.random((3, 300)) - 0.5
    j, p = JVortical(), VorticalFlow()
    np.testing.assert_allclose(p.solution(_t(xyz), 0.0).numpy(),
                               np.asarray(j.solution(jnp.asarray(xyz), 0.0)),
                               rtol=0, atol=PROB_ATOL)
    s0 = p.src(_t(xyz), 0.0)
    np.testing.assert_allclose(s0.numpy(),
                               np.asarray(j.src(jnp.asarray(xyz), 0.0)),
                               rtol=0, atol=PROB_ATOL)
    assert float(s0.abs().max()) > 0.1
    assert p.steady
    for t in (0.25, torch.tensor(1.5, dtype=F64)):
        assert torch.equal(p.src(_t(xyz), t), s0)


def test_system_callbacks_match(case):
    """flux_at_nodes, charspeed and dt of both systems on a seeded state."""
    name, mesh, js, ts, _ = case
    rng = np.random.default_rng(6)
    u = _state(rng, name, mesh.nnode)
    xyz = np.asarray(js.geom.coords)
    for fj, ft in zip(js.system.flux_at_nodes(jnp.asarray(u),
                                              jnp.asarray(xyz)),
                      ts.system.flux_at_nodes(_t(u), _t(xyz))):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj),
                                   rtol=RHS_RTOL, atol=1e-14)
    np.testing.assert_allclose(
        ts.system.charspeed(_t(u), _t(xyz)).numpy(),
        np.asarray(js.system.charspeed(jnp.asarray(u), jnp.asarray(xyz))),
        rtol=RHS_RTOL)
    assert np.isclose(float(ts.system.dt(ts.geom, _t(u))),
                      float(js.system.dt(js.geom, jnp.asarray(u))),
                      rtol=DT_RTOL, atol=0)


def test_stage_rhs_matches_xla(case):
    """The plain K7/K8/K9 stage rhs against the JAX package's
    alecg_flux_rhs + alecg_dissipation, 1e-13 of the largest entry; the
    port's own XLA-formulation functions agree with both."""
    name, mesh, js, ts, _ = case
    u = _state(np.random.default_rng(7), name, mesh.nnode)
    jg, je = js.geom, js.edget
    want = np.asarray(
        j_flux_rhs(js.system, jg, jnp.asarray(u))
        + j_dissipation(js.system, jg, je.edges, je.A, je.ensup,
                        jnp.asarray(u), exyz=je.xyz))
    tg, te = ts.geom, ts.edget
    cv = alecg_vol_plain(ts.system, tg, ts.rows, _t(u))
    d = alecg_edge_plain(ts.system, te, ts.rows, _t(u))
    got = cg_assemble_plain(cv, d, tg.nsup, te.ensup)
    assert torch.equal(got, alecg_rhs(ts.system, tg, te, ts.rows, _t(u)))
    assert _rel(got.numpy(), want) <= RHS_RTOL
    xla = (alecg_flux_rhs(ts.system, tg, _t(u))
           + alecg_dissipation(ts.system, tg, te.edges, te.A, te.ensup,
                               _t(u), exyz=te.xyz))
    assert _rel(xla.numpy(), want) <= RHS_RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_stage_rhs_matches_pallas(name):
    """The plain K7/K8/K9 stage rhs against the Pallas B9 (transport) and
    B10 (compflow) window kernels in interpret mode, on a 6x6x4 mesh,
    1e-12 of the largest entry: the port computes what the TPU kernels
    compute."""
    meshkw, systems, cfl, _ = CASES[name]
    lo = meshkw.get("lo", (0.0, 0.0, 0.0))
    hi = meshkw["hi"]
    mesh = _ordered(6, 6, 4, lo=lo, hi=hi)
    jsys, tsys = systems()
    js = j_make_alecg(jsys, mesh, cfl=cfl)
    ts = make_alecg(tsys, mesh, cfl=cfl, device="cpu")
    fp = build_alecg_fused_plan(jsys, js.geom, js.edget)
    assert fp is not None and fp.kind == ("compflow" if name == "vortical"
                                          else "transport")
    u = _state(np.random.default_rng(8), name, mesh.nnode)
    want = np.asarray(alecg_rhs_fused(fp, jnp.asarray(u), interpret=True,
                                      system=jsys))
    got = alecg_rhs(ts.system, ts.geom, ts.edget, ts.rows, _t(u))
    assert _rel(got.numpy(), want) <= PALLAS_RTOL


@pytest.mark.parametrize("name", ["slotcyl", "slotcyl3"])
def test_velocity_rows_match_jax_corner_rows(name):
    """K7 transport's node velocity rows, read at each element corner
    through inpoelT, are the JAX package's per-corner rows of its fused
    plan (v_n at estat rows 13 + (b*C + c)*3 + j) bit for bit; with three
    components they are one row, the same at every component."""
    meshkw, systems, cfl, _ = CASES[name]
    mesh = _ordered(6, 6, 4, hi=meshkw["hi"])
    jsys, tsys = systems()
    js = j_make_alecg(jsys, mesh, cfl=cfl)
    ts = make_alecg(tsys, mesh, cfl=cfl, device="cpu")
    fp = build_alecg_fused_plan(jsys, js.geom, js.edget)
    C, E = tsys.ncomp, mesh.nelem
    vel = ts.rows.vel
    assert vel.shape == (1, 3, mesh.nnode) and vel.is_contiguous()
    estat = np.asarray(fp.estat)
    for b in range(4):
        corner = vel[0][:, ts.geom.inpoelT[b].long()].numpy()  # (3, E)
        for c in range(C):
            rows = estat[13 + (b * C + c) * 3:16 + (b * C + c) * 3, :E]
            np.testing.assert_array_equal(corner, rows)


def test_solver_matches_jax(case):
    """ALECG against make_alecg's XLA path from the initial state, every
    step: the whole u (SlotCyl absolute, VorticalFlow relative to max|u|)
    to 1e-12, t and dt rtol 1e-12, Diagnostics rows to rtol 1e-10
    (VorticalFlow's error norms are ~1e-7 of max|u|, so u's last digits
    show in their 12th)."""
    name, mesh, js, ts, nsteps = case
    a, b = js.initial_state(), ts.initial_state()
    np.testing.assert_array_equal(b.u.numpy(), np.asarray(a.u))
    for n in range(1, nsteps + 1):
        a, b = js.step(a), ts.step(b)
        ua = np.asarray(a.u)
        err = np.abs(b.u.numpy() - ua).max()
        if name == "vortical":
            err /= np.abs(ua).max()
        assert err <= U_TOL, (n, err)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL, atol=0)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL, atol=0)
        assert int(b.it) == int(a.it) == n
    rj = JDiag(js.system, js.geom).compute(a)
    rt = Diagnostics(ts.system, ts.geom).compute(b)
    assert rt.it == rj.it
    for x, y in ((rt.l2sol, rj.l2sol), (rt.l2err, rj.l2err),
                 (rt.linferr, rj.linferr)):
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-14)
    st = convert.cg_state_from_arrays(
        {k: np.asarray(getattr(a, k)) for k in ("u", "t", "it", "dt")},
        device="cpu")
    for k, v in convert.cg_state_to_arrays(st).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(a, k)))


def test_const_dt_matches_jax():
    """const_dt overrides the (static) transport dt: 3 SlotCyl steps."""
    mesh = _ordered(6, 6, 3, hi=(1.0, 1.0, 0.5))
    bc = mesh.all_bnodes()
    js = j_make_alecg(JTransport(JSlotCyl()), mesh, const_dt=1e-3,
                      bcnodes=bc)
    ts = make_alecg(CGTransport(SlotCyl()), mesh, const_dt=1e-3, bcnodes=bc,
                    device="cpu")
    a = js.nsteps(js.initial_state(), 3)
    b = ts.nsteps(ts.initial_state(), 3)
    assert float(b.dt) == 1e-3 and abs(float(b.t) - 3e-3) < 1e-15
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=U_TOL)


def test_cpu_tensors_launch_no_alecg_kernel(case):
    """CPU tensors take the plain versions: a solver step launches no
    kernel, and the K7-K9 wrappers refuse CPU tensors (no fallback)."""
    name, mesh, js, ts, _ = case
    kernels.reset_launches()
    ts.step(ts.initial_state())
    assert set(kernels.launches.values()) == {0}
    u = ts.initial_state().u
    g, e, rows = ts.geom, ts.edget, ts.rows
    with pytest.raises(ValueError, match="CUDA tensor"):
        if name != "vortical":
            kernels.alecg_vol(u, g.inpoelT, g.grad, rows.w, rows.vel)
        else:
            kernels.alecg_vol_cf(u, g.inpoelT, g.grad, rows.w,
                                 ts.system.eos)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if name != "vortical":
            kernels.alecg_edge(u, e.edges, rows.ew)
        else:
            kernels.alecg_edge_cf(u, e.edges, rows.ew, ts.system.eos)
    cv = torch.zeros((u.shape[0], g.nelem), dtype=F64)
    d = torch.zeros((u.shape[0], e.edges.shape[1]), dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.cg_assemble(cv, d, g.nsup, e.ensup)
    assert set(kernels.launches.values()) == {0}
