"""The port's tracer particles against quinoa_tpu.particles, on the CPU.

The same particles (seed_particles draws from the same numpy generator in
both packages) go through the JAX tracker (jax x64 from tests/conftest.py)
and the port's torch tracker in float64 on a refined box: barycentric
coordinates, the neighbour walk, nodal interpolation, and five RK2 steps
with each velocity source (the analytic SlotCyl rotation, nodal CG
compflow momentum, DG cell means).  Element ids are held equal and
positions to XP_ATOL.  The chunked nearest-centroid re-homing after a
remesh is held equal to the JAX CLI's dense (P, E) search
(quinoa_tpu.cli._particles_remesh), and to numpy's first index on ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quinoa_tpu.particles.tracker as jtr
from quinoa_tpu.amr import refine_mesh as j_refine
from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.pde.problems import SlotCyl as JSlotCyl

import quinoa_tpu_torch.particles.tracker as ttr
from quinoa_tpu_torch.amr import refine_mesh as t_refine
from quinoa_tpu_torch.mesh import box_tet_mesh as t_box
from quinoa_tpu_torch.mesh.derived import gen_inpoed
from quinoa_tpu_torch.pde.problems import SlotCyl as TSlotCyl

XP_ATOL = 1e-13
NPAR = 400
NSTEPS = 5


@pytest.fixture(scope="module")
def meshes():
    """(port mesh, JAX mesh): a unit box refined by a random tag set, so
    the walk crosses elements of different sizes."""
    tm, jm = t_box(5, 5, 2, hi=(1.0, 1.0, 0.4)), j_box(5, 5, 2,
                                                       hi=(1.0, 1.0, 0.4))
    edges = gen_inpoed(tm.inpoel).astype(np.int64)
    rng = np.random.default_rng(4)
    tags = edges[rng.choice(len(edges), size=len(edges) // 10,
                            replace=False)]
    tm, _ = t_refine(tm, tags)
    jm, _ = j_refine(jm, tags)
    np.testing.assert_array_equal(tm.inpoel, jm.inpoel)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    return tm, jm


def tgeom(mesh):
    return ttr.make_tracker_geom(mesh, torch.float64, "cpu")


def test_seed_particles_equal(meshes):
    tm, jm = meshes
    for seed in (0, 3):
        txp, tep = ttr.seed_particles(tm, NPAR, seed)
        jxp, jep = jtr.seed_particles(jm, NPAR, seed)
        np.testing.assert_array_equal(txp, jxp)
        np.testing.assert_array_equal(tep, jep)
        assert tep.dtype == jep.dtype == np.int32


def test_tracker_geom_equal(meshes):
    tm, jm = meshes
    tg, jg = tgeom(tm), jtr.make_tracker_geom(jm)
    for f in ("grad", "cent", "esuel", "inpoelT", "coords"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def _jittered(mesh, seed, scale):
    """Seeded particles moved by up to scale, with their seed elements:
    most leave their element, a few the box."""
    xp, ep = ttr.seed_particles(mesh, NPAR, seed)
    rng = np.random.default_rng(seed + 100)
    return xp + scale * rng.uniform(-1.0, 1.0, xp.shape), ep


def test_barycentric_locate_interp(meshes):
    tm, jm = meshes
    tg, jg = tgeom(tm), jtr.make_tracker_geom(jm)
    xp, ep = _jittered(tm, 1, 0.15)
    txp, tep = torch.as_tensor(xp), torch.as_tensor(ep).long()
    jxp, jep = jnp.asarray(xp), jnp.asarray(ep)
    np.testing.assert_allclose(ttr.barycentric(tg, txp, tep).numpy(),
                               np.asarray(jtr.barycentric(jg, jxp, jep)),
                               rtol=0, atol=1e-15)
    for hops in (1, 4, 8):
        got = ttr.locate(tg, txp, tep, hops).numpy()
        want = np.asarray(jtr.locate(jg, jxp, jep, hops))
        np.testing.assert_array_equal(got, want)
        assert (got != ep).sum() > NPAR // 4   # the walk moved most
    lam = ttr.barycentric(tg, txp, tep)
    vals = np.random.default_rng(2).standard_normal((3, tm.nnode))
    np.testing.assert_allclose(
        ttr.interp_nodal(tg, tep, lam, torch.as_tensor(vals)).numpy(),
        np.asarray(jtr.interp_nodal(jg, jep, jnp.asarray(lam.numpy()),
                                    jnp.asarray(vals))),
        rtol=0, atol=1e-15)


def _sources(tm, jm):
    """(name, port velocity_of, JAX velocity_of, vargs of the step, dt)
    for the three velocity sources."""
    rng = np.random.default_rng(6)
    nod = np.empty((5, tm.nnode))
    nod[0] = 1.0 + 0.5 * rng.random(tm.nnode)
    nod[1:4] = nod[0] * rng.uniform(-1.0, 1.0, (3, tm.nnode))
    nod[4] = 2.5
    cel = 0.1 * rng.standard_normal((5, 4, tm.nelem))
    cel[0, 0] = 1.0 + 0.5 * rng.random(tm.nelem)
    cel[1:4, 0] = cel[0, 0] * rng.uniform(-1.0, 1.0, (3, tm.nelem))
    cel = cel.reshape(20, -1)
    return [
        ("analytic", ttr.analytic_velocity(TSlotCyl()),
         jtr.analytic_velocity(JSlotCyl()), (), 0.09),
        ("nodal", ttr.nodal_velocity(), jtr.nodal_velocity(), (nod,), 0.03),
        ("cell", ttr.cell_velocity(5, 4), jtr.cell_velocity(5, 4), (cel,),
         0.03),
    ]


@pytest.mark.parametrize("source", ["analytic", "nodal", "cell"])
def test_advance_five_steps(meshes, source):
    """Five RK2 steps with each velocity source: ep equal, xp to
    XP_ATOL; some particles cross elements and some stick at a wall."""
    tm, jm = meshes
    name, tvel, jvel, vargs, dt = [s for s in _sources(tm, jm)
                                   if s[0] == source][0]
    tt = ttr.ParticleTracker(tm, tvel, dtype=torch.float64, device="cpu")
    jt = jtr.ParticleTracker(jm, jvel)
    xp, ep = ttr.seed_particles(tm, NPAR, 5)
    txp, tep = torch.as_tensor(xp), torch.as_tensor(ep)
    jxp, jep = jnp.asarray(xp), jnp.asarray(ep)
    tv = tuple(torch.as_tensor(v) for v in vargs)
    jv = tuple(jnp.asarray(v) for v in vargs)
    t = 0.0
    for _ in range(NSTEPS):
        txp, tep = tt.advance(txp, tep, t, dt, *tv)
        jxp, jep = jt.advance(jxp, jep, t, dt, *jv)
        t += dt
        np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
        np.testing.assert_allclose(txp.numpy(), np.asarray(jxp), rtol=0,
                                   atol=XP_ATOL)
    assert (tep.numpy() != ep).sum() > NPAR // 10
    lam = ttr.barycentric(tt.geom, txp, tep)
    assert float(lam.min()) >= -ttr.STUCK_TOL


def test_nearest_centroid_chunks_and_ties():
    """The chunked search gives numpy's dense argmin, first index on
    ties, whatever the chunk."""
    rng = np.random.default_rng(9)
    cent = rng.random((3, 50))
    cent[:, 30] = cent[:, 7]          # duplicates: a tie
    cent[:, 41] = cent[:, 7]
    xp = rng.random((3, 37))
    xp[:, 5] = cent[:, 7] + 1e-9
    g = ttr.TrackerGeom(grad=torch.zeros(4, 3, 50, dtype=torch.float64),
                        cent=torch.as_tensor(cent),
                        esuel=torch.zeros(4, 50, dtype=torch.int64),
                        inpoelT=torch.zeros(4, 50, dtype=torch.int64),
                        coords=torch.zeros(3, 1, dtype=torch.float64))
    want = np.argmin(((cent[:, None, :] - xp[:, :, None]) ** 2).sum(axis=0),
                     axis=1)
    assert want[5] == 7
    for max_pairs in (1, 50, 333, 1 << 20):
        got = ttr.nearest_centroid(g, torch.as_tensor(xp), max_pairs)
        np.testing.assert_array_equal(got.numpy(), want)


def test_particles_remesh_matches_the_jax_cli(meshes):
    """After five steps the mesh is refined again; the port's CLI re-homes
    the particles (chunked search + 4 x 4 hops) to the elements the JAX
    CLI's dense search and walk find."""
    from quinoa_tpu.cli import _particles_remesh as j_remesh
    from quinoa_tpu_torch.cli import _particles_remesh as t_remesh

    tm, jm = meshes
    tt = ttr.ParticleTracker(tm, ttr.analytic_velocity(TSlotCyl()),
                             dtype=torch.float64, device="cpu")
    jt = jtr.ParticleTracker(jm, jtr.analytic_velocity(JSlotCyl()))
    xp, ep = ttr.seed_particles(tm, NPAR, 8)
    txp, tep = torch.as_tensor(xp), torch.as_tensor(ep)
    jxp, jep = jnp.asarray(xp), jnp.asarray(ep)
    for k in range(NSTEPS):
        txp, tep = tt.advance(txp, tep, 0.05 * k, 0.05)
        jxp, jep = jt.advance(jxp, jep, 0.05 * k, 0.05)
    edges = gen_inpoed(tm.inpoel).astype(np.int64)
    tags = edges[np.random.default_rng(12).choice(
        len(edges), size=len(edges) // 5, replace=False)]
    tm2, _ = t_refine(tm, tags)
    jm2, _ = j_refine(jm, tags)
    tpt = dict(tracker=tt, xp=txp, ep=tep)
    jpt = dict(tracker=jt, xp=jxp, ep=jep)
    t_remesh(tpt, tm2)
    j_remesh(jpt, jm2)
    np.testing.assert_array_equal(tpt["ep"].numpy(), np.asarray(jpt["ep"]))
    assert tt.geom.cent.shape[1] == tm2.nelem
    lam = ttr.barycentric(tt.geom, tpt["xp"], tpt["ep"])
    assert float(lam.min()) >= -ttr.INSIDE_TOL
    # one more step on the new mesh
    txp, tep = tt.advance(tpt["xp"], tpt["ep"], 0.25, 0.05)
    jxp, jep = jt.advance(jpt["xp"], jpt["ep"], 0.25, 0.05)
    np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
    np.testing.assert_allclose(txp.numpy(), np.asarray(jxp), rtol=0,
                               atol=XP_ATOL)


def test_tracker_defaults_to_the_card(meshes):
    """Without device= the tracker builds on the card: with none it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.ParticleTracker(meshes[0], ttr.nodal_velocity())
