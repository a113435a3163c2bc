"""The port's h-AMR host passes against quinoa_tpu.amr, on the CPU.

quinoa_tpu_torch/amr is the port's own numpy copy of quinoa_tpu/amr (and
of the t0ref passes, control/config.apply_t0ref, and the geometry helper
node_gradients), written in the same operation order.  The same float64
inputs, made from numpy seeds on small boxes, go through both, and
everything is held bit for bit (np.array_equal): closed tag sets, refined
meshes (coords, inpoel, side sets, side-set nodes), refine maps (parent,
mid_edges, rebuilt groups), derefinement with its conformity locks, the
edge errors, tags, the multi-pass marker over random tag sequences, four
events of the incremental dtref cycle on CG and DG(P1) input, every
solution transfer, and apply_t0ref in each mode.  The JAX package's
geometry runs its native pass where that library loads, and the port's is
written in that pass's order; where the library does not load, its numpy
fallback differs by an ulp, and the float results are then held to
FALLBACK_RTOL instead.
"""

import os
import time

import numpy as np
import pytest
import torch

import quinoa_tpu.amr as jamr
import quinoa_tpu.amr.adapt as jadapt
import quinoa_tpu.amr.multipass as jmp
import quinoa_tpu.amr.refine as jref
from quinoa_tpu.control.config import apply_t0ref as j_t0ref
from quinoa_tpu.control.config import load_inciter as j_load
from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.mesh.derived import gen_inpoed as j_inpoed
from quinoa_tpu.mesh.geometry import node_gradients as j_node_gradients
from quinoa_tpu.pde.problems import SlotCyl as JSlotCyl

import quinoa_tpu_torch.amr as tamr
import quinoa_tpu_torch.amr.adapt as tadapt
import quinoa_tpu_torch.amr.multipass as tmp
import quinoa_tpu_torch.amr.refine as tref
from quinoa_tpu_torch.control.config import apply_t0ref as t_t0ref
from quinoa_tpu_torch.control.config import load_inciter as t_load
from quinoa_tpu_torch.mesh import box_tet_mesh as t_box
from quinoa_tpu_torch.mesh.derived import gen_inpoed as t_inpoed
from quinoa_tpu_torch.mesh.geometry import (einsum_jacobians, nodal_volumes,
                                            node_gradients)
from quinoa_tpu_torch.pde.problems import SlotCyl as TSlotCyl

#: relative tolerance of float results where the JAX package's geometry
#: runs its numpy fallback (an ulp off its native pass)
FALLBACK_RTOL = 1e-14


def jax_native_loads():
    """Whether the JAX package's native library loads (retried once from
    a reset loader: another process may be rebuilding it in place)."""
    import quinoa_tpu.native as qn

    if qn.lib() is None and os.environ.get("QUINOA_TPU_NO_NATIVE") != "1":
        time.sleep(1.0)
        qn._TRIED, qn._LIB = False, None
    return qn.lib() is not None


@pytest.fixture(scope="module")
def exact():
    return jax_native_loads()


def same(got, want, exact=True, what=""):
    """Integer and bool arrays equal; float arrays bit for bit (within
    FALLBACK_RTOL where exact is false)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact or not np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=FALLBACK_RTOL, atol=0,
                                   err_msg=what)


def same_mesh(tm, jm):
    same(tm.coords, jm.coords, what="coords")
    same(tm.inpoel, jm.inpoel, what="inpoel")
    assert sorted(tm.bface) == sorted(jm.bface)
    for ss in jm.bface:
        same(tm.bface[ss], jm.bface[ss], what=f"bface {ss}")
    assert sorted(tm.bnode) == sorted(jm.bnode)
    for ss in jm.bnode:
        same(tm.bnode[ss], jm.bnode[ss], what=f"bnode {ss}")


def same_map(tr, jr):
    same(tr.mid_edges, jr.mid_edges, what="mid_edges")
    same(tr.parent, jr.parent, what="parent")
    assert tr.nnode_old == jr.nnode_old
    assert (tr.rebuilt is None) == (jr.rebuilt is None)
    assert len(tr.rebuilt or []) == len(jr.rebuilt or [])
    for (ta, tb), (ja, jb) in zip(tr.rebuilt or [], jr.rebuilt or []):
        same(ta, ja, what="rebuilt old rows")
        same(tb, jb, what="rebuilt new rows")


def same_state(ts, js):
    assert len(ts.groups) == len(js.groups)
    for tg, jg in zip(ts.groups, js.groups):
        assert (tg.kind, tg.which) == (jg.kind, jg.which)
        for f in ("parent", "children", "mids", "mid_pairs"):
            same(getattr(tg, f), getattr(jg, f), what=f)
        assert len(tg.btris) == len(jg.btris)
        for (ts_, tt), (js_, jt) in zip(tg.btris, jg.btris):
            assert ts_ == js_
            same(tt, jt, what="btris")


def boxes(n=(4, 4, 3), hi=(1.0, 1.0, 0.75)):
    """(port mesh, JAX mesh) of the same box, checked equal."""
    tm, jm = t_box(*n, hi=hi), j_box(*n, hi=hi)
    same_mesh(tm, jm)
    return tm, jm


def random_tags(rng, edges, frac):
    n = max(1, int(frac * len(edges)))
    return edges[rng.choice(len(edges), size=n, replace=False)].astype(
        np.int64)


def front(coords, x0, width=0.08):
    """A smooth front across x = x0 (values in [0.1, 1.9]) and a second
    component that varies in y."""
    x, y = coords[:, 0], coords[:, 1]
    return np.stack([1.0 + 0.9 * np.tanh((x - x0) / width),
                     1.5 + 0.5 * np.sin(3.0 * y)])


@pytest.mark.parametrize("seed,n,frac", [(0, (4, 4, 3), 0.03),
                                         (1, (5, 4, 4), 0.08),
                                         (2, (6, 5, 4), 0.2)])
def test_compatible_tags_and_refine_mesh(seed, n, frac):
    """compatible_tags closes the same set; refine_mesh gives the same
    mesh (coords, inpoel, side sets) and refine map; transfer_cg and
    transfer_dg the same fields."""
    rng = np.random.default_rng(seed)
    tm, jm = boxes(n)
    edges = j_inpoed(jm.inpoel)
    same(t_inpoed(tm.inpoel), edges, what="gen_inpoed")
    tags = random_tags(rng, edges, frac)
    same(tamr.compatible_tags(tm.inpoel.astype(np.int64), tags),
         jamr.compatible_tags(jm.inpoel.astype(np.int64), tags),
         what="closure")
    tm2, tr = tamr.refine_mesh(tm, tags)
    jm2, jr = jamr.refine_mesh(jm, tags)
    assert jm2.nelem > jm.nelem
    same_mesh(tm2, jm2)
    same_map(tr, jr)
    u = rng.standard_normal((2, jm.nnode))
    same(tref.transfer_cg(tr, u), jref.transfer_cg(jr, u), what="cg")
    ud = rng.standard_normal((5 * 4, jm.nelem))
    same(tref.transfer_dg(tr, ud, 5, 4), jref.transfer_dg(jr, ud, 5, 4),
         what="dg")
    # the geometric orientation oracle agrees with the template parity
    same(tref._orient(tm2.inpoel.astype(np.int64), tm2.coords),
         jref._orient(jm2.inpoel.astype(np.int64), jm2.coords),
         what="_orient")


def test_uniform_refine():
    tm, jm = boxes((3, 3, 2))
    tm2, tr = tamr.uniform_refine(tm)
    jm2, jr = jamr.uniform_refine(jm)
    assert jm2.nelem == 8 * jm.nelem
    same_mesh(tm2, jm2)
    same_map(tr, jr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derefine_with_conformity_locks(seed, exact):
    """A random coarsening request against a refined box: the surviving
    refinement, the coarsened flags and both derefine transfers."""
    rng = np.random.default_rng(10 + seed)
    tm, jm = boxes((4, 4, 3))
    tags = random_tags(rng, j_inpoed(jm.inpoel), 0.25)
    tm2, tr = tamr.refine_mesh(tm, tags)
    jm2, jr = jamr.refine_mesh(jm, tags)
    request = rng.random(jm.nelem) < 0.6
    tm3, tr3, tc = tamr.derefine_mesh(tm, tr, request)
    jm3, jr3, jc = jamr.derefine_mesh(jm, jr, request)
    assert jm3 is not None and jc.any()
    # the locks keep some requested parents refined
    assert (request & ~jc & (np.bincount(jr.parent) > 1)).any()
    same_mesh(tm3, jm3)
    same_map(tr3, jr3)
    same(tc, jc, what="coarsened")
    u = rng.standard_normal((3, jm2.nnode))
    same(tref.transfer_cg_derefine(tr, tr3, u),
         jref.transfer_cg_derefine(jr, jr3, u), what="cg derefine")
    ud = rng.standard_normal((5 * 4, jm2.nelem))
    from quinoa_tpu.mesh.geometry import tet_geometry as j_geo
    from quinoa_tpu_torch.mesh.geometry import tet_geometry as t_geo

    vt, vj = t_geo(tm2.coords, tm2.inpoel)[0] / 6.0, \
        j_geo(jm2.coords, jm2.inpoel)[0] / 6.0
    same(vt, vj, exact, "volumes")
    same(tref.transfer_dg_derefine(tm, tr, tr3, ud, vt, 5, 4),
         jref.transfer_dg_derefine(jm, jr, jr3, ud, vj, 5, 4), exact,
         "dg derefine")
    # nothing requested: nothing changes
    t_none = tamr.derefine_mesh(tm, tr, np.zeros(jm.nelem, bool))
    j_none = jamr.derefine_mesh(jm, jr, np.zeros(jm.nelem, bool))
    assert t_none[0] is None and j_none[0] is None
    same(t_none[2], j_none[2])


@pytest.mark.parametrize("method", ["jump", "hessian"])
def test_edge_errors_and_tags(method, exact):
    """edge_errors, tag_edges_by_error (one tolerance per quartile of
    the errors) and node_gradients on a refined box with a front."""
    tm, jm = boxes((5, 4, 3))
    tags = random_tags(np.random.default_rng(3), j_inpoed(jm.inpoel), 0.1)
    tm, _ = tamr.refine_mesh(tm, tags)
    jm, _ = jamr.refine_mesh(jm, tags)
    u = front(jm.coords, 0.45)
    for comp in (0, 1):
        e_t = tamr.edge_errors(tm, u, comp, method)
        e_j = jamr.edge_errors(jm, u, comp, method)
        same(e_t, e_j, exact, f"{method} errors comp {comp}")
        for tol in np.quantile(e_j, [0.25, 0.5, 0.75]):
            same(tamr.tag_edges_by_error(tm, u, comp, method, tol),
                 jamr.tag_edges_by_error(jm, u, comp, method, tol),
                 what="tags")
    from quinoa_tpu.mesh.geometry import nodal_volumes as j_nv

    vol = j_nv(jm.coords, jm.inpoel, jm.nnode)
    same(node_gradients(tm.coords, tm.inpoel, vol, u.T),
         j_node_gradients(jm.coords, jm.inpoel, vol, u.T), exact,
         "node_gradients")
    # the hessian's volumes: the JAX nodal_volumes' own (einsum) Jacobians
    same(nodal_volumes(tm.coords, tm.inpoel, tm.nnode,
                       J=einsum_jacobians(tm.coords, tm.inpoel)), vol,
         exact, "nodal_volumes")


@pytest.mark.parametrize("planes", [
    dict(xminus=0.3), dict(xplus=0.6, yminus=0.25),
    dict(xminus=0.5, xplus=0.2, yminus=0.5, yplus=0.75, zminus=0.25,
         zplus=0.5)])
def test_tag_edges_by_coords(planes):
    tm, jm = boxes((4, 4, 3))
    got = tamr.tag_edges_by_coords(tm, **planes)
    want = jamr.tag_edges_by_coords(jm, **planes)
    assert len(want)
    same(got, want, what="coords tags")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mark_and_refine_pass_random_sequences(seed):
    """Three refine_pass rounds of random tags (the fractions of
    tests/test_multipass.py), then one uniform pass over the live partial
    groups (2:8 and 4:8 rebuilds): mark_pass's decisions, the meshes,
    maps, intermediates state and transfer_dg_pass, at each pass; one
    round with banned (level-capped) edges."""
    rng = np.random.default_rng(seed)
    tm, jm = boxes((3, 3, 3), hi=(1.0, 1.0, 1.0))
    ts, js = tmp.AMRState(), jmp.AMRState()
    rebuilt = 0
    for k, frac in enumerate((0.05, 0.08, 0.05, None)):
        edges = j_inpoed(jm.inpoel).astype(np.int64)
        tags = edges if frac is None else random_tags(rng, edges, frac)
        banned = (random_tags(rng, edges, 0.05) if k == 1 else None)
        try:
            jmark = jmp.mark_pass(jm, tags, js, banned=banned)
        except AssertionError:
            with pytest.raises(AssertionError):
                tmp.mark_pass(tm, tags, ts, banned=banned)
            break
        tmark = tmp.mark_pass(tm, tags, ts, banned=banned)
        same(tmark[0], jmark[0], what="hasmask")
        same(tmark[1], jmark[1], what="rebuild")
        tm2, tr, ts = tmp.refine_pass(tm, tags, ts, banned=banned)
        jm2, jr, js = jmp.refine_pass(jm, tags, js, banned=banned)
        same_mesh(tm2, jm2)
        same_map(tr, jr)
        same_state(ts, js)
        rebuilt += len(jr.rebuilt)
        ud = rng.standard_normal((3 * 4, jm.nelem))
        vol = rng.random(jm.nelem) + 0.5
        same(tmp.transfer_dg_pass(tr, ud, vol, 3, 4),
             jmp.transfer_dg_pass(jr, ud, vol, 3, 4), what="dg pass")
        tm, jm = tm2, jm2
    if seed == 0:
        assert rebuilt, "no partial group was rebuilt"


def _dg_input(rng, mesh, x0):
    """A DG(P1) modal state (5 * 4, E): cell means of the front at the
    centroids (density first), random higher dofs."""
    cen = mesh.coords[mesh.inpoel].mean(axis=1)
    f = front(cen, x0)
    u = 0.05 * rng.standard_normal((5, 4, mesh.nelem))
    u[0, 0] = f[0]
    u[1:, 0] = f[1] + 0.1 * rng.standard_normal((4, mesh.nelem))
    return u.reshape(20, -1)


@pytest.mark.parametrize("scheme", ["cg", "dg"])
def test_dtref_adapt_four_events(scheme, exact):
    """Four incremental AMR events with a front moving across the box:
    the first refines, later ones coarsen the region the front left and
    refine where it went (maxlevels 2 caps the depth).  Each event's
    changed flag, mesh, transferred solution, element levels, level chain
    and intermediates state are the JAX package's."""
    rng = np.random.default_rng(5)
    tm, jm = boxes((6, 4, 2), hi=(1.0, 0.6, 0.3))
    tchain = jchain = None
    from quinoa_tpu_torch.cli import _nodal_cell_means

    sizes = [jm.nelem]
    for x0 in (0.3, 0.7, 0.72, 0.75):
        if scheme == "cg":
            u = front(jm.coords, x0)
            uerr, ncomp, ndof = u, 2, None
        else:
            u = _dg_input(rng, jm, x0)
            ncomp, ndof = 5, 4
            uerr = _nodal_cell_means(jm, u, ncomp, ndof)
        kw = dict(method="jump", tol_refine=0.2, tol_derefine=0.1,
                  maxlevels=2)
        tc, tm2, tchain, tu = tadapt.dtref_adapt(
            tm, tchain, uerr, u, scheme == "cg", ncomp, ndof, **kw)
        jc, jm2, jchain, ju = jadapt.dtref_adapt(
            jm, jchain, uerr, u, scheme == "cg", ncomp, ndof, **kw)
        assert tc == jc
        same_mesh(tm2, jm2)
        same(tu, ju, exact, "transferred u")
        same(tchain.elevel, jchain.elevel, what="elevel")
        assert len(tchain.levels) == len(jchain.levels)
        for (tcm, trm, tl), (jcm, jrm, jl) in zip(tchain.levels,
                                                  jchain.levels):
            same_mesh(tcm, jcm)
            same_map(trm, jrm)
            same(tl, jl, what="level")
        same_state(tchain.state, jchain.state)
        tm, jm = tm2, jm2
        sizes.append(jm.nelem)
    steps = np.diff(sizes)
    assert (steps > 0).any() and (steps < 0).any(), sizes


def test_dtref_nodal_cell_means_match_the_jax_cli():
    """The DG error field of the port's CLI (nodal averages of the cell
    means) against the JAX CLI's loops, through one maxlevels-1 event."""
    from quinoa_tpu.cli import _dtref_remesh as j_remesh
    from quinoa_tpu_torch.cli import _dtref_remesh as t_remesh

    rng = np.random.default_rng(8)
    tm, jm = boxes((6, 4, 2), hi=(1.0, 0.6, 0.3))
    u = _dg_input(rng, jm, 0.4)
    cfg_t = t_load("inciter amr dtref true maxlevels 1 tol_refine 0.2 end "
                   "end")
    cfg_j = j_load("inciter amr dtref true maxlevels 1 tol_refine 0.2 end "
                   "end")
    tres = t_remesh(cfg_t, tm, None, None, u, False, 5, 4)
    jres = j_remesh(cfg_j, jm, None, None, u, False, 5, 4)
    assert tres[0] is jres[0] is True
    same_mesh(tres[1], jres[1])
    same_map(tres[3], jres[3])
    same(tres[4], jres[4], what="u")


T0REF = {
    "uniform": "initial uniform",
    "coords": "initial coords coordref x- 0.3 y+ 0.5 end",
    "ic": "initial ic error jump tol_refine 0.2",
    "edgelist": "initial edgelist edgelist 0 1 1 7 3 4 2 9 end",
    "uniform_derefine": "initial uniform initial coords coordref x+ 0.5 "
                        "end initial uniform initial uniform_derefine",
    "all": "initial ic initial coords coordref z- 0.2 end initial uniform "
           "initial edgelist edgelist 0 1 end initial uniform_derefine",
}


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.mark.parametrize("mode", sorted(T0REF))
def test_apply_t0ref(mode, f64):
    deck = f"inciter amr t0ref true {T0REF[mode]} end end"
    cfg_t, cfg_j = t_load(deck), j_load(deck)
    assert cfg_t.amr_initial == cfg_j.amr_initial
    tm, jm = boxes((4, 4, 2), hi=(1.0, 1.0, 0.5))
    if "ic" in cfg_j.amr_initial:
        with pytest.raises(ValueError, match="needs a problem"):
            t_t0ref(cfg_t, tm)
        with pytest.raises(ValueError, match="needs a problem"):
            j_t0ref(cfg_j, jm)
        tp, jp = TSlotCyl(), JSlotCyl()
    else:
        tp = jp = None
    got = t_t0ref(cfg_t, tm, problem=tp)
    want = j_t0ref(cfg_j, jm, problem=jp)
    assert want.nelem > jm.nelem
    same_mesh(got, want)
