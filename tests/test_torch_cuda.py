"""Card tests of quinoa_tpu_torch's CUDA kernels (marker ``cuda``).

Each kernel against its plain torch version on the same card tensors, and
the solver on the card against the same solver on the CPU.  They skip
where there is no CUDA device; on a machine with one (and nvcc) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the repo's conftest configures jax, which the card machine
need not have; this file imports no jax).
"""

import numpy as np
import pytest
import torch

from quinoa_tpu_torch import kernels
from quinoa_tpu_torch.inciter.dg import DGSolver
from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
from quinoa_tpu_torch.ops.face_fused import (face_flux_plain,
                                             face_to_elem_plain,
                                             fused_face_pass)
from quinoa_tpu_torch.ops.nbr_bounds import (limit_vol_plain,
                                             superbee_limit_window)
from quinoa_tpu_torch.pde.dg import BC_SYMMETRY, build_dggeom
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
from quinoa_tpu_torch.pde.problems import SedovBlastwave

pytestmark = pytest.mark.cuda

#: kernel and plain version share operation order and build without
#: fused multiply-adds: they agree to a few ulp of the largest entry
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda", 0)


def _geom(device, dtype):
    mesh, _ = hilbert_element_reorder(
        box_tet_mesh(6, 6, 4, hi=(0.6, 0.6, 0.4)))
    return build_dggeom(mesh, 4, {i: BC_SYMMETRY for i in range(1, 7)},
                        dtype=dtype, device=device)


def _state(E, dtype, device):
    rng = np.random.default_rng(7)
    U = rng.random((20, E)) * 0.01
    U[0] += 1.0
    U[16] += 2.5
    return torch.as_tensor(U).to(dtype).to(device)


def _close(got, want, dtype):
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL[dtype] * float(
            w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_versions(card, dtype):
    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, dtype)
    U = _state(g.nelem, dtype, card)
    kernels.reset_launches()
    ulim, rv = superbee_limit_window(g, U, system)
    _close((ulim, rv), limit_vol_plain(system, g, U), dtype)
    r, delt = fused_face_pass(system, g, ulim, rv)
    _close((r, delt),
           face_to_elem_plain(g, *face_flux_plain(system, g, ulim), rv),
           dtype)
    torch.cuda.synchronize()
    assert kernels.launches == {"limit_vol": 1, "face_flux": 1,
                                "face_to_elem": 1}


def test_face_kernel_pad_faces(card):
    """fmask = 0 faces contribute exactly nothing even over all-zero
    (0/0) states, in the kernel as in the plain version."""
    import dataclasses

    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, torch.float64)
    pad = torch.zeros(g.nface, dtype=torch.bool, device=card)
    pad[::7] = True
    g = dataclasses.replace(g, fmask=torch.where(pad, 0.0, g.fmask))
    U = _state(g.nelem, torch.float64, card)
    U[:, g.el[pad].long()] = 0.0
    got = kernels.face_flux(U, g.el, g.er, g.fn, g.farea, g.fmask, g.xi_l,
                            g.xi_r, g.bctype, g.ktab, system.eos)
    for k, p in zip(got, face_flux_plain(system, g, U)):
        assert bool((k[..., pad] == 0).all()) and bool(
            (p[..., pad] == 0).all())


def test_solver_on_card_matches_cpu(card):
    """Two float64 steps from the Sedov IC (which has face points of
    negative pressure: NaN propagation must match), atol 1e-11."""
    system = DGCompFlow(SedovBlastwave())
    a = DGSolver(system, _geom(card, torch.float64), limiter="superbeep1")
    b = DGSolver(system, _geom("cpu", torch.float64), limiter="superbeep1")
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    assert bool(torch.isfinite(sa.u).all())
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
