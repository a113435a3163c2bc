"""test_torch_spmd.py's sharded DG parity tests on DG(P2) TaylorGreen and
rDG p0p1: S = 4 port shards against quinoa_tpu's SPMDDGSolver (one step)
and against the port's single-device solver (5 steps), at that file's
tolerances.  A file of its own so that the JAX side's compiles spread
over the test workers."""

import pytest

import test_torch_spmd as base
from test_torch_spmd import f64  # noqa: F401  (the fixture)

HERE = tuple(k for k in base.CASES if k not in base.HERE)


@pytest.mark.parametrize("name", HERE)
def test_spmd_dg_matches_jax_spmd(f64, name):  # noqa: F811
    base.test_spmd_dg_matches_jax_spmd(f64, name)


@pytest.mark.parametrize("name", HERE)
def test_spmd_dg_matches_single_device(f64, name):  # noqa: F811
    base.test_spmd_dg_matches_single_device(f64, name)
