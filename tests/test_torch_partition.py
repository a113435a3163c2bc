"""The port's partitioners, load distributor, LPT packing and Morton
renumbering against quinoa_tpu's, on the CPU.

Every algorithm of the JAX package's _ALGOS (sfc, hsfc, rcb, rib, mj,
phg), the weighted SFC with its never-empty repair, the two-level
(--slices) partition, linear_load_distributor, lpt_assign and sfc_reorder
give the JAX package's integers exactly, on a box and on a rotated cloud
(tests/test_partition.py:50) at S = 2, 3, 4 and 8.  The JAX package's
morton_partition takes its native Morton codes where its library loads
and its numpy codes otherwise: the port's parts equal both.
"""

import os
import time

import numpy as np
import pytest

import quinoa_tpu.native as qn
from quinoa_tpu.base.load import linear_load_distributor as j_lld
from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.mesh.reorder import sfc_reorder as j_sfc_reorder
from quinoa_tpu.parallel import overdecomp as j_od
from quinoa_tpu.parallel import partition as jp

from quinoa_tpu_torch.base.load import linear_load_distributor
from quinoa_tpu_torch.mesh import box_tet_mesh, sfc_reorder
from quinoa_tpu_torch.parallel import partition as tp
from quinoa_tpu_torch.parallel.overdecomp import lpt_assign

ALGOS = ("sfc", "hsfc", "rcb", "rib", "mj", "phg")
NPARTS = (2, 3, 4, 8)


def _box():
    m = box_tet_mesh(7, 5, 4, hi=(1.0, 0.7, 0.5))
    return m.coords, m.inpoel


def _cloud():
    rng = np.random.default_rng(0)
    pts = rng.random((4000, 3)) * [10.0, 1.0, 1.0]
    th = np.pi / 4
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    return pts @ R.T


def jax_native_loads():
    """Whether the JAX package's native library loads; a failed load is
    tried once more, a second later, from a reset loader (its loader runs
    make in every process, and a load during another's rebuild fails)."""
    if qn.lib() is None and os.environ.get("QUINOA_TPU_NO_NATIVE") != "1":
        time.sleep(1.0)
        qn._TRIED, qn._LIB = False, None
    return qn.lib() is not None


@pytest.fixture(params=["native", "numpy"])
def jax_codes(request, monkeypatch):
    """The JAX package's Morton codes by one route: its native library
    (skipped where it does not load) or its numpy fallback."""
    if request.param == "native":
        if not jax_native_loads():
            pytest.skip("the JAX package's native library does not load")
    else:
        monkeypatch.setattr(qn, "morton_codes", lambda pts: None)
    return request.param


@pytest.mark.parametrize("nparts", NPARTS)
@pytest.mark.parametrize("algo", ALGOS)
def test_partition_elements_equal_jax(jax_codes, algo, nparts):
    coords, inpoel = _box()
    want = jp.partition_elements(coords, inpoel, nparts, algo)
    got = tp.partition_elements(coords, inpoel, nparts, algo)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nparts", NPARTS)
@pytest.mark.parametrize("fn", ["morton_partition", "rcb_partition",
                                "rib_partition", "mj_partition"])
def test_cloud_partitions_equal_jax(jax_codes, fn, nparts):
    pts = _cloud()
    np.testing.assert_array_equal(getattr(tp, fn)(pts, nparts),
                                  getattr(jp, fn)(pts, nparts))


@pytest.mark.parametrize("nparts", NPARTS)
def test_weighted_sfc_equal_jax(jax_codes, nparts):
    """Weighted SFC (dynamic load balancing), with one element heavier
    than a whole weight window: the never-empty repair keeps every part."""
    coords, inpoel = _box()
    rng = np.random.default_rng(3)
    w = rng.integers(1, 5, inpoel.shape[0]).astype(np.float64)
    w[17] = w.sum()          # swallows windows without the repair
    want = jp.partition_elements(coords, inpoel, nparts, weights=w)
    got = tp.partition_elements(coords, inpoel, nparts, weights=w)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == nparts


@pytest.mark.parametrize("nslice,cps", [(2, 2), (2, 4), (4, 2), (3, 1)])
def test_hierarchical_equal_jax(jax_codes, nslice, cps):
    coords, inpoel = _box()
    for algo in ("sfc", "rcb"):
        np.testing.assert_array_equal(
            tp.partition_for(coords, inpoel, nslice * cps, algo,
                             hierarchy=(nslice, cps)),
            jp.partition_for(coords, inpoel, nslice * cps, algo,
                             hierarchy=(nslice, cps)))
    with pytest.raises(ValueError, match="hierarchy"):
        tp.partition_for(coords, inpoel, nslice * cps + 1, "sfc",
                         hierarchy=(nslice, cps))


def test_partition_errors_as_jax():
    coords, inpoel = _box()
    for bad in (dict(nparts=0), dict(nparts=2, algorithm="nope")):
        with pytest.raises(ValueError):
            jp.partition_elements(coords, inpoel, **bad)
        with pytest.raises(ValueError):
            tp.partition_elements(coords, inpoel, **bad)
    np.testing.assert_array_equal(tp.partition_elements(coords, inpoel, 1),
                                  np.zeros(inpoel.shape[0], np.int32))


@pytest.mark.parametrize("u", [0.0, 0.25, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("npe", [1, 2, 3, 8])
def test_linear_load_distributor_equal_jax(u, npe):
    for load in (1, 7, 1000, 663552):
        assert linear_load_distributor(u, load, npe) == j_lld(u, load, npe)
    with pytest.raises(ValueError):
        linear_load_distributor(1.5, 10, 2)
    with pytest.raises(ValueError):
        linear_load_distributor(0.5, 0, 2)


@pytest.mark.parametrize("npes,cpd", [(1, 3), (2, 2), (3, 4), (8, 2)])
def test_lpt_assign_equal_jax(npes, cpd):
    rng = np.random.default_rng(npes * 10 + cpd)
    for costs in (rng.integers(1, 100, npes * cpd).astype(float),
                  np.ones(npes * cpd)):
        np.testing.assert_array_equal(lpt_assign(costs, npes, cpd),
                                      j_od.lpt_assign(costs, npes, cpd))


def test_sfc_reorder_equal_jax():
    m, jm = box_tet_mesh(5, 4, 3), j_box(5, 4, 3)
    out, nperm, eperm = sfc_reorder(m)
    jout, jn, je = j_sfc_reorder(jm)
    np.testing.assert_array_equal(nperm, jn)
    np.testing.assert_array_equal(eperm, je)
    np.testing.assert_array_equal(out.coords, jout.coords)
    np.testing.assert_array_equal(out.inpoel, jout.inpoel)
    assert out.inpoel.dtype == jout.inpoel.dtype
    assert sorted(out.bface) == sorted(jout.bface)
    for k in jout.bface:
        np.testing.assert_array_equal(out.bface[k], jout.bface[k])
        np.testing.assert_array_equal(out.bnode[k], jout.bnode[k])
