"""The plain reference against the port on a small jittered box, float64
on the CPU, for every configuration: the same element order, initial
state and steps to round-off."""

import numpy as np
import pytest
import torch

from benchlib import catalog, meshgen
from benchlib.harness import _mesh

DIMS = {"sedov_dgp1": (6, 6, 5), "mm_sod_dgp1": (16, 3, 2)}


@pytest.fixture
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize("name", sorted(DIMS))
def test_reference_follows_the_port(name, float64):
    from quinoa_tpu_torch.control.config import build_inciter, load_inciter
    from quinoa_tpu_torch.mesh.reorder import hilbert_element_reorder

    cfg = catalog.config(name)
    mesh = meshgen.box(DIMS[name], cfg["lo"], cfg["hi"], 0.1, 2**31 + 17)
    pmesh, eorder = hilbert_element_reorder(_mesh(torch, mesh))
    solver, _ = build_inciter(load_inciter(cfg["deck_text"]), pmesh, device="cpu")
    ref = catalog.config_module(cfg, "reference").make(
        cfg["deck_text"], mesh, "cpu", "float64")
    assert np.array_equal(ref.eorder, eorder)
    st, rs = solver.initial_state(), ref.initial_state()
    assert torch.allclose(st.u, rs.u, rtol=0, atol=1e-12 * float(rs.u.abs().max()))
    for _ in range(4):
        st, rs = solver.step(st), ref.step(rs)
        scale = rs.u.abs().amax(dim=1, keepdim=True)
        assert float(((st.u - rs.u).abs() / scale).max()) < 1e-10
        assert abs(float(st.dt) - rs.dt) <= 1e-13 * rs.dt
