"""quinoa_tpu_torch geometry against quinoa_tpu: the Hilbert element
reorder, build_dggeom's tables, the convert.py round trip and the
initial projection.

Float64 on the CPU.  The geometry is built by the same numpy code paths
in both packages, so tables are compared for exact equality.
"""

import dataclasses

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


def test_hilbert_reorder_matches(meshes, monkeypatch):
    """Same codes and element order as quinoa_tpu, with the native pass
    and with the numpy fallback."""
    mesh, jmesh = meshes
    tmesh, eorder = t_reorder.hilbert_element_reorder(mesh)
    _, jorder = j_reorder(mesh)
    np.testing.assert_array_equal(eorder, jorder)
    np.testing.assert_array_equal(tmesh.inpoel, jmesh.inpoel)
    pts = mesh.coords[mesh.inpoel].mean(axis=1)
    import quinoa_tpu.native as native

    monkeypatch.setattr(native, "hilbert_codes", lambda *a, **k: None)
    np.testing.assert_array_equal(t_reorder.hilbert_codes(pts),
                                  j_hilbert_codes(pts))


@pytest.mark.parametrize("bc", [
    {i: BC_SYMMETRY for i in range(1, 7)},
    {1: BC_SYMMETRY, 4: BC_OUTLET},  # the rest default to extrapolate
])
def test_build_dggeom_tables_equal(meshes, bc):
    """Every field and table of the port's geometry equals quinoa_tpu's:
    face order, fose, fsideR and esuelT included."""
    _, mesh = meshes
    jg = jax_geom_arrays(j_build(mesh, ndof=4, bc_sidesets=bc))
    tg = convert.geom_to_arrays(t_build(mesh, ndof=4, bc_sidesets=bc,
                                        dtype=torch.float64))
    for name in GEOM_TENSOR_FIELDS:
        assert tg[name].shape == jg[name].shape, name
        assert tg[name].dtype == jg[name].dtype, name
        np.testing.assert_array_equal(tg[name], jg[name], err_msg=name)
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
    back = convert.geom_to_arrays(convert.geom_from_arrays(arrays))
    for name in GEOM_TENSOR_FIELDS:
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    g32 = convert.geom_from_arrays(arrays, dtype=torch.float32)
    assert g32.vol.dtype == torch.float32 and g32.fose.dtype == torch.int32
    np.testing.assert_array_equal(g32.xi_l.numpy(),
                                  arrays["xi_l"].astype(np.float32))

    js = JSolver(JCompFlow(JSedov()), jgeom, cfl=0.5, limiter="superbeep1")
    st = js.initial_state()
    sarr = {k: np.asarray(getattr(st, k)) for k in convert.STATE_FIELDS}
    tstate = convert.state_from_arrays(sarr)
    assert tstate.u.shape == sarr["u"].shape
    for k, v in convert.state_to_arrays(tstate).items():
        np.testing.assert_array_equal(v, sarr[k], err_msg=k)


def test_dg_initialize_matches(meshes):
    """L2 projection of the Sedov IC, atol 1e-12 on energies ~2e3 (the
    14-point sums run in another order)."""
    _, mesh = meshes
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = j_build(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(jax_geom_arrays(jg))
    uj = np.asarray(j_init(JCompFlow(JSedov()), jg, 0.0))
    ut = t_init(TCompFlow(TSedov()), tg, 0.0).numpy()
    assert np.abs(uj).max() > 1e3  # the hot corner is inside the box
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-12)
