"""quinoa_tpu_torch geometry against quinoa_tpu: the Hilbert element
reorder, build_dggeom's tables, the convert.py round trip and the
initial projection.

Float64 on the CPU.  The port builds the geometry with numpy written in the
operation order of the JAX package's native passes, so tables are
compared for exact equality whenever the JAX package's native library
loads.  Where it does not (QUINOA_TPU_NO_NATIVE=1, or no toolchain), the
JAX package takes its numpy fallback, whose face coordinates xi_l differ
from the native pass's by 1 ulp in some entries: the float fields are then
held to 1 ulp of 1 (FALLBACK_ATOL), the integer fields still exactly.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_codes as j_hilbert_codes
from quinoa_tpu.mesh.reorder import hilbert_element_reorder as j_reorder
from quinoa_tpu.pde.dg import build_dggeom as j_build, dg_initialize as j_init
from quinoa_tpu.pde.dg import BC_SYMMETRY, BC_OUTLET
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.mesh import reorder as t_reorder
from quinoa_tpu_torch.pde.dg import GEOM_TENSOR_FIELDS
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.dg import dg_initialize as t_init
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov


#: one ulp of 1 in float64 (2.2e-16), rounded up: the JAX numpy
#: fallback's xi_l against the native pass's
FALLBACK_ATOL = 2.3e-16


def jax_native_loads():
    """Whether the JAX package's native library loads.  Its loader runs
    make in every process and caches a failed load, and a process that
    loads the library while another rebuilds it in place fails: so a
    failed load is tried once more, a second later, from a reset loader."""
    import quinoa_tpu.native as qn

    if qn.lib() is None and os.environ.get("QUINOA_TPU_NO_NATIVE") != "1":
        time.sleep(1.0)
        qn._TRIED, qn._LIB = False, None
    return qn.lib() is not None


def jax_geom_arrays(g):
    """A JAX DGGeom as the dict of numpy arrays convert.py takes."""
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name != "tables"}
    out["tables"] = {k: np.asarray(v) for k, v in g.tables.items()}
    return out


@pytest.fixture(scope="module")
def meshes():
    mesh = box_tet_mesh(4, 4, 3, hi=(0.4, 0.4, 0.3))
    return mesh, j_reorder(mesh)[0]


def test_hilbert_reorder_matches(meshes):
    """Same codes and element order as quinoa_tpu: the port's numpy pass
    against the JAX package's native one (its numpy fallback where the
    library is not built)."""
    mesh, jmesh = meshes
    tmesh, eorder = t_reorder.hilbert_element_reorder(mesh)
    _, jorder = j_reorder(mesh)
    np.testing.assert_array_equal(eorder, jorder)
    np.testing.assert_array_equal(tmesh.inpoel, jmesh.inpoel)
    pts = mesh.coords[mesh.inpoel].mean(axis=1)
    np.testing.assert_array_equal(t_reorder.hilbert_codes(pts),
                                  j_hilbert_codes(pts))


@pytest.mark.parametrize("bc", [
    {i: BC_SYMMETRY for i in range(1, 7)},
    {1: BC_SYMMETRY, 4: BC_OUTLET},  # the rest default to extrapolate
])
def test_build_dggeom_tables_equal(meshes, bc):
    """Every field and table of the port's geometry equals quinoa_tpu's:
    face order, fose, fsideR and esuelT included; bit for bit against the
    JAX package's native geometry, or within FALLBACK_ATOL on the float
    fields against its numpy fallback where the native library does not
    load."""
    _, mesh = meshes
    native = jax_native_loads()
    against = ("the JAX package's native geometry" if native else
               f"the JAX package's numpy fallback (atol {FALLBACK_ATOL})")
    jg = jax_geom_arrays(j_build(mesh, ndof=4, bc_sidesets=bc))
    tg = convert.geom_to_arrays(t_build(mesh, ndof=4, bc_sidesets=bc,
                                        dtype=torch.float64, device="cpu"))
    for name in GEOM_TENSOR_FIELDS:
        msg = f"{name} against {against}"
        assert tg[name].shape == jg[name].shape, msg
        assert tg[name].dtype == jg[name].dtype, msg
        if native or not np.issubdtype(jg[name].dtype, np.floating):
            np.testing.assert_array_equal(tg[name], jg[name], err_msg=msg)
        else:
            np.testing.assert_allclose(tg[name], jg[name], rtol=0,
                                       atol=FALLBACK_ATOL, err_msg=msg)
    assert tg["ndof"] == jg["ndof"] and tg["nelem_real"] == jg["nelem_real"]
    assert set(tg["tables"]) == set(jg["tables"])
    for k, v in jg["tables"].items():
        np.testing.assert_allclose(tg["tables"][k], v, rtol=0, atol=1e-15,
                                   err_msg=k)


def test_convert_round_trip(meshes):
    """JAX geometry and state -> numpy dicts -> port -> dicts: unchanged
    in float64, and cast once in float32."""
    from quinoa_tpu.inciter.dg import DGSolver as JSolver

    _, mesh = meshes
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jgeom = j_build(mesh, ndof=4, bc_sidesets=bc)
    arrays = jax_geom_arrays(jgeom)
    back = convert.geom_to_arrays(convert.geom_from_arrays(arrays,
                                                           device="cpu"))
    for name in GEOM_TENSOR_FIELDS:
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    g32 = convert.geom_from_arrays(arrays, dtype=torch.float32, device="cpu")
    assert g32.vol.dtype == torch.float32 and g32.fose.dtype == torch.int32
    np.testing.assert_array_equal(g32.xi_l.numpy(),
                                  arrays["xi_l"].astype(np.float32))

    js = JSolver(JCompFlow(JSedov()), jgeom, cfl=0.5, limiter="superbeep1")
    st = js.initial_state()
    sarr = {k: np.asarray(getattr(st, k)) for k in convert.STATE_FIELDS}
    tstate = convert.state_from_arrays(sarr, device="cpu")
    assert tstate.u.shape == sarr["u"].shape
    for k, v in convert.state_to_arrays(tstate).items():
        np.testing.assert_array_equal(v, sarr[k], err_msg=k)


def test_dg_initialize_matches(meshes):
    """L2 projection of the Sedov IC, atol 1e-12 on energies ~2e3 (the
    14-point sums run in another order)."""
    _, mesh = meshes
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = j_build(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(jax_geom_arrays(jg), device="cpu")
    uj = np.asarray(j_init(JCompFlow(JSedov()), jg, 0.0))
    ut = t_init(TCompFlow(TSedov()), tg, 0.0).numpy()
    assert np.abs(uj).max() > 1e3  # the hot corner is inside the box
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-12)


def _builder_calls(mesh):
    """Each port builder called without a device, on small inputs."""
    from quinoa_tpu_torch.inciter.alecg import build_edge_tables, make_alecg
    from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu_torch.pde.problems import SlotCyl

    g = t_build(mesh, 4, {i: BC_SYMMETRY for i in range(1, 7)},
                device="cpu")
    garr = convert.geom_to_arrays(g)
    cg = make_cggeom(mesh, device="cpu")
    cgarr = convert.cg_geom_to_arrays(cg)
    u = np.zeros((20, g.nelem))
    sarr = {"u": u, "ndofel": np.full(g.nelem, 4), "t": 0.0, "it": 0,
            "dt": 0.0}
    carr = {"u": np.zeros((1, cg.nnode)), "t": 0.0, "it": 0, "dt": 0.0}
    earr = convert.edge_tables_to_arrays(build_edge_tables(mesh,
                                                           device="cpu"))
    return {
        "build_dggeom": lambda: t_build(mesh, 4, {1: BC_SYMMETRY}),
        "make_cggeom": lambda: make_cggeom(mesh),
        "build_edge_tables": lambda: build_edge_tables(mesh),
        "make_alecg": lambda: make_alecg(CGTransport(SlotCyl()), mesh),
        "geom_from_arrays": lambda: convert.geom_from_arrays(garr),
        "state_from_arrays": lambda: convert.state_from_arrays(sarr),
        "cg_geom_from_arrays": lambda: convert.cg_geom_from_arrays(cgarr),
        "edge_tables_from_arrays":
            lambda: convert.edge_tables_from_arrays(earr),
        "cg_state_from_arrays": lambda: convert.cg_state_from_arrays(carr),
    }


@pytest.mark.parametrize("builder", [
    "build_dggeom", "make_cggeom", "build_edge_tables", "make_alecg",
    "geom_from_arrays", "state_from_arrays", "cg_geom_from_arrays",
    "edge_tables_from_arrays", "cg_state_from_arrays"])
def test_builders_default_to_the_card(monkeypatch, builder):
    """Called without a device, every builder targets CUDA: with no CUDA
    device it raises instead of building on the CPU."""
    from quinoa_tpu_torch.mesh import box_tet_mesh as t_box

    call = _builder_calls(t_box(2, 2, 2))[builder]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
