"""The port's sharded multimat, DiagCG and ALECG solvers against
quinoa_tpu's SPMD solvers and against the port's own single-device
solvers, on the CPU in float64.

S = 4 port shards (ShardGroup on the CPU) against the JAX package's SPMD
solver over 4 devices of the virtual 8-device CPU mesh, two steps from
the same initial state: the gathered state within the single-device
parity tests' tolerance (u atol 1e-11 of max(1, max|u|), dt and t rtol
1e-12; tests/test_torch_diagcg.py, tests/test_torch_p0.py).  Then 5 steps
against the port's single-device solver at the JAX package's
equivalence tolerances: rtol 1e-9, atol 1e-12 (tests/test_asynclogic.py
:78), multimat atol 1e-9 of max(1, max|u|) (:99), and the diagnostics.
The cases: multimat Sod DG(P1) with consistent Superbee and THINC,
DiagCG SlotCyl with FCT (the FCT bounds [0, 0.6] kept), ALECG SlotCyl
transport and VorticalFlow Euler (the _cf kernels' path); each on
overdecomposed shards too (-u 0.5 at npes 2), single-device side only.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.parallel import SPMDALECGSolver as JALECG
from quinoa_tpu.parallel import SPMDDiagCGSolver as JDiagCG
from quinoa_tpu.parallel import build_alecg_shards as j_alecg_shards
from quinoa_tpu.parallel import build_cg_shards as j_cg_shards
from quinoa_tpu.parallel.dg_shard import build_dg_shards as j_dg_shards
from quinoa_tpu.parallel.dg_spmd import SPMDMultiMatSolver as JMM
from quinoa_tpu.parallel.shard import gather_global_field as j_gather
from quinoa_tpu.pde import problems as jprob
from quinoa_tpu.pde.problems.multimat import MMSodShocktube as JMMSod
from quinoa_tpu.pde.cg import CGTransport as JTransport
from quinoa_tpu.pde.cg_compflow import CGCompFlow as JCompFlow
from quinoa_tpu.pde.multimat import MultiMatSystem as JMMSystem

from quinoa_tpu_torch.inciter import DiagCGSolver, Diagnostics, make_alecg
from quinoa_tpu_torch.inciter.dg import DGDiagnostics
from quinoa_tpu_torch.mesh import box_tet_mesh
from quinoa_tpu_torch.parallel import (SPMDALECGSolver, SPMDDiagCGSolver,
                                       SPMDMultiMatSolver, ShardGroup,
                                       build_alecg_shards, build_cg_shards,
                                       build_dg_shards)
from quinoa_tpu_torch.parallel import overdecomp
from quinoa_tpu_torch.pde import problems as tprob
from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
from quinoa_tpu_torch.pde.dg import build_dggeom
from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem

S = 4
U_ATOL = 1e-11
DT_RTOL = 1e-12
EQ_RTOL, EQ_ATOL = 1e-9, 1e-12
MM_ATOL = 1e-9
SOD = {1: 3, 2: 3, 3: 2, 4: 2, 5: 2, 6: 2}


def _cpu(n):
    return ShardGroup(n, ["cpu"])


#: name: (box n, lo, hi, cfl)
CG = {"diagcg": ((6, 6, 4), (0.0, 0.0, 0.0), (1.0, 1.0, 0.5), 0.8),
      "alecg": ((6, 6, 4), (0.0, 0.0, 0.0), (1.0, 1.0, 0.5), 0.8),
      "alecg_cf": ((5, 5, 5), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), 0.5)}
MM_BOX = ((8, 4, 4), (1.0, 0.5, 0.5))


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _jmesh():
    return Mesh(np.array(jax.devices()[:S]), ("shard",))


def _close_states(got_u, want_u, got, want):
    np.testing.assert_allclose(got_u, want_u, rtol=0,
                               atol=U_ATOL * max(1.0, np.abs(want_u).max()))
    for f in ("t", "dt"):
        np.testing.assert_allclose([float(x) for x in getattr(got, f)],
                                   np.asarray(getattr(want, f)),
                                   rtol=DT_RTOL)


def _mm_port(mesh, sharded):
    system = MultiMatSystem(tprob.MMSodShocktube(), intsharp=True)
    return system, SPMDMultiMatSolver(system, sharded, cfl=0.5,
                                      limiter="superbeep1")


def test_multimat_thinc_matches_jax_spmd(f64):
    n, hi = MM_BOX
    mesh = box_tet_mesh(*n, hi=hi)
    _, port = _mm_port(mesh, build_dg_shards(mesh, S, 4, SOD,
                                             dtype=torch.float64,
                                             group=_cpu(S)))
    js = JMM(JMMSystem(JMMSod(), intsharp=True),
             j_dg_shards(j_box(*n, hi=hi), S, 4, SOD), _jmesh(), cfl=0.5,
             limiter="superbeep1")
    a = js.nsteps(js.initial_state(), 2)
    b = port.nsteps(port.initial_state(), 2)
    _close_states(port.gather_global(b), js.gather_global(a), b, a)


@pytest.mark.parametrize("over", [False, True])
def test_multimat_thinc_matches_single_device(f64, over):
    n, hi = MM_BOX
    mesh = box_tet_mesh(*n, hi=hi)
    sh = (overdecomp.build_overdecomposed_dg(mesh, 2, 0.5, 4, SOD,
                                             group=_cpu(2)).sharded
          if over else build_dg_shards(mesh, S, 4, SOD, group=_cpu(S)))
    system, port = _mm_port(mesh, sh)
    g = build_dggeom(mesh, 4, SOD, dtype=torch.float64, device="cpu")
    single = MultiMatSolver(MultiMatSystem(tprob.MMSodShocktube(),
                                           intsharp=True), g, cfl=0.5,
                            limiter="superbeep1")
    a = single.nsteps(single.initial_state(), 5)
    b = port.nsteps(port.initial_state(), 5)
    u = a.u.numpy()
    np.testing.assert_allclose(port.gather_global(b), u, rtol=0,
                               atol=MM_ATOL * max(1.0, np.abs(u).max()))
    for got, ref in zip(port.diagnostics(b),
                        DGDiagnostics(single.system, g).compute(a)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=MM_ATOL)


def test_multimat_route_leaves_the_system_alone(f64):
    """The sharded solver names one route for every shard, the face
    Gauss-point route when some shard has a Dirichlet face (here two of
    the four touch sideset 5), and writes nothing on the system: a single-device solver on
    the same system and a Dirichlet-free geometry keeps the face pass."""
    n, hi = MM_BOX
    mesh = box_tet_mesh(*n, hi=hi)
    system = MultiMatSystem(tprob.MMSodShocktube())
    system.fused_ok = True               # the caller's route for rhs
    dirichlet = {**SOD, 5: 1}            # BC_DIRICHLET on sideset 5
    sh = build_dg_shards(mesh, S, 1, dirichlet, group=_cpu(S))
    has = [bool((g.bctype == 1).any()) for g in sh.geoms]
    assert any(has) and not all(has)
    single = MultiMatSolver(system, build_dggeom(mesh, 1, SOD,
                                                 device="cpu"))
    port = SPMDMultiMatSolver(system, sh, cfl=0.5)
    assert single.route.face == "k14"
    assert [sv.route.face for sv in port.shards] == ["mm_dirichlet"] * S
    assert system.fused_ok is True


def _cg_case(name):
    n, lo, hi, cfl = CG[name]
    mesh = box_tet_mesh(*n, lo=lo, hi=hi)
    jm = j_box(*n, lo=lo, hi=hi)
    if name == "alecg_cf":
        return (mesh, jm, cfl, CGCompFlow(tprob.VorticalFlow()),
                JCompFlow(jprob.VorticalFlow()))
    return (mesh, jm, cfl, CGTransport(tprob.SlotCyl()),
            JTransport(jprob.SlotCyl()))


def _cg_port(name, mesh, system, cfl, over=False):
    bn = mesh.all_bnodes()
    if name == "diagcg":
        sh = (overdecomp.build_overdecomposed_cg(
            mesh, 2, 0.5, 1, bcnodes=bn, group=_cpu(2)).sharded
              if over else build_cg_shards(mesh, S, 1, bcnodes=bn,
                                            group=_cpu(S)))
        return SPMDDiagCGSolver(system, sh, cfl=cfl)
    C = system.ncomp
    sh = (overdecomp.build_overdecomposed_alecg(
        mesh, 2, 0.5, C, bcnodes=bn, group=_cpu(2)).sharded
          if over else build_alecg_shards(mesh, S, C, bcnodes=bn,
                                            group=_cpu(S)))
    return SPMDALECGSolver(system, sh, cfl=cfl)


@pytest.mark.parametrize("name", sorted(CG))
def test_cg_matches_jax_spmd(f64, name):
    mesh, jm, cfl, system, jsystem = _cg_case(name)
    port = _cg_port(name, mesh, system, cfl)
    bn = jm.all_bnodes()
    if name == "diagcg":
        jsh = j_cg_shards(jm, S, 1, bcnodes=bn)
        js = JDiagCG(jsystem, jsh, _jmesh(), cfl=cfl)
        jcg = jsh
    else:
        jsh = j_alecg_shards(jm, S, jsystem.ncomp, bcnodes=bn)
        js = JALECG(jsystem, jsh, _jmesh(), cfl=cfl)
        jcg = jsh.cg
    a = js.nsteps(js.initial_state(), 2)
    b = port.nsteps(port.initial_state(), 2)
    _close_states(port.gather_global(b), j_gather(jcg, a.u), b, a)


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", sorted(CG))
def test_cg_matches_single_device(f64, name, over):
    mesh, _, cfl, system, _ = _cg_case(name)
    port = _cg_port(name, mesh, system, cfl, over)
    bn = mesh.all_bnodes()
    if name == "diagcg":
        single = DiagCGSolver(system, make_cggeom(mesh, device="cpu"),
                              cfl=cfl, bcnodes=bn)
    else:
        single = make_alecg(system, mesh, cfl=cfl, bcnodes=bn,
                            device="cpu")
    a = single.nsteps(single.initial_state(), 5)
    b = port.nsteps(port.initial_state(), 5)
    u = port.gather_global(b)
    np.testing.assert_allclose(u, a.u.numpy(), rtol=EQ_RTOL, atol=EQ_ATOL)
    row = Diagnostics(system, single.geom).compute(a)
    for got, ref in zip(port.diagnostics(b),
                        (row.l2sol, row.l2err, row.linferr)):
        np.testing.assert_allclose(got, ref, rtol=EQ_RTOL, atol=EQ_ATOL)
    if name == "diagcg":   # FCT keeps SlotCyl in its initial bounds
        assert u.min() >= -1e-12 and u.max() <= 0.6 + 1e-12
