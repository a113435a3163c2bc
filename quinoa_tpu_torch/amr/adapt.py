"""Incremental multi-level during-timestep AMR.

The port's own copy of quinoa_tpu/amr/adapt.py (host-side numpy, the same
operations in the same order).

The reference refines incrementally from the CURRENT mesh each dtref
event, compounding up to MAX_REFINEMENT_LEVEL=4
(src/Inciter/AMR/refinement.hpp:28,60; mesh_adapter refine/derefine
cycle), and coarsens sibling groups whose error dropped.  This module
drives that cycle on host state as a chain of one-level refinement
events, reusing refine_mesh/derefine_mesh and their transfers:

- chain: list of (coarse_mesh, rmap, coarse_elevel) — each entry maps
  one level to the next; the last entry's refinement IS the current
  mesh; elevel tracks per-element refinement depth (level cap).
- each cycle: (1) coarsen top-level sibling groups whose elements' edge
  errors are ALL below tol_derefine (popping exhausted levels), then
  (2) refine current-mesh edges whose error exceeds tol_refine, only
  where an incident element sits below maxlevels.

This incremental cycle IS the default (maxlevels defaults to 4, the
reference's hard-coded cap) — a reference deck gets the reference's
compounding dtref evolution.  `maxlevels 1` in the amr block opts out
to the single-level retag-from-base scheme (cli._dtref_remesh), an
extension this repo keeps for cheap one-level tracking runs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..mesh.derived import gen_inpoed
from .error import edge_errors
from .refine import (
    refine_mesh, derefine_mesh, transfer_cg, transfer_dg,
    transfer_cg_derefine, transfer_dg_derefine, _edge_key, _TET_EDGES,
)


class AdaptChain:
    """Mutable multi-level refinement state for one run.

    `state` is the PERSISTENT intermediates machine (amr.multipass
    AMRState): the partial 1:2/1:4 template groups and their locks are
    carried ACROSS dtref events, exactly as the reference's Refiner
    keeps one long-lived AMR::mesh_adapter_t for t0ref and every
    during-timestep event (Refiner.cpp:241-260; mesh_adapter.cpp:538
    lock_intermediates) — so an event that tags a partial child's
    unlocked edge re-refines the PARENT 2:8/4:8 instead of stacking a
    template.  Coarsening rebuilds the level from its coarse mesh
    (derefine_mesh), which invalidates the live groups — the state is
    reset there, the same convention as t0ref's uniform_derefine
    (control/config.py apply_t0ref)."""

    def __init__(self, mesh):
        self.levels: List[tuple] = []  # (coarse_mesh, rmap, coarse_elevel)
        self.elevel = np.zeros(mesh.nelem, dtype=np.int64)
        from .multipass import AMRState

        self.state = AMRState()


def _elem_edge_err(mesh, uerr, method):
    """Max edge-error per element of the current mesh."""
    err = edge_errors(mesh, uerr, 0, method)
    edges = gen_inpoed(mesh.inpoel)
    keys = _edge_key(edges[:, 0], edges[:, 1])
    order = np.argsort(keys)
    ks, es = keys[order], err[order]
    inpoel = mesh.inpoel.astype(np.int64)
    ek = _edge_key(inpoel[:, _TET_EDGES[:, 0]], inpoel[:, _TET_EDGES[:, 1]])
    pos = np.searchsorted(ks, ek)
    return es[np.clip(pos, 0, len(ks) - 1)].max(axis=1)  # (E,)


def _elem_volumes(mesh):
    from ..mesh.geometry import tet_geometry

    J, _ = tet_geometry(mesh.coords, mesh.inpoel)
    return J / 6.0


def dtref_adapt(mesh, chain: Optional[AdaptChain], uerr, u, cg_scheme,
                ncomp, ndof, method="jump", tol_refine=0.2,
                tol_derefine=0.05, maxlevels=4):
    """One incremental AMR cycle on host state.

    uerr : (C, nnode) nodal indicator field on the CURRENT mesh
    u    : the solution to transfer ((C, nnode) nodal or (C*ndof, E)
           modal)
    Returns (changed, mesh, chain, u_transferred)."""
    if chain is None:
        chain = AdaptChain(mesh)
    changed = False

    # ---- (1) coarsen the top level ------------------------------------
    # a level whose rmap folded in 2:8/4:8 partial-group rebuilds has no
    # complete coarse->fine parent map (rebuilt children's parent is not
    # an element of the coarse mesh): skip coarsening it — its region
    # was just re-refined, so its error is above tol anyway
    if chain.levels and (chain.levels[-1][1].parent >= 0).all():
        coarse, rmap, coarse_lvl = chain.levels[-1]
        eerr = _elem_edge_err(mesh, uerr, method)
        ncoarse = coarse.nelem
        cnt = np.bincount(rmap.parent, minlength=ncoarse)
        worst = np.zeros(ncoarse)
        np.maximum.at(worst, rmap.parent, eerr)
        request = (cnt > 1) & (worst < tol_derefine)
        if request.any():
            vol_cur = None if cg_scheme else _elem_volumes(mesh)
            mesh2, rmap2, coarsened = derefine_mesh(coarse, rmap, request)
            if mesh2 is not None:
                if cg_scheme:
                    u = transfer_cg_derefine(rmap, rmap2, u)
                else:
                    u = transfer_dg_derefine(coarse, rmap, rmap2, u,
                                             vol_cur, ncomp, ndof)
                mesh = mesh2
                changed = True
                if len(rmap2.mid_edges) == 0:
                    chain.levels.pop()
                    chain.elevel = coarse_lvl.copy()
                else:
                    chain.levels[-1] = (coarse, rmap2, coarse_lvl)
                    cnt2 = np.bincount(rmap2.parent, minlength=ncoarse)
                    chain.elevel = (
                        coarse_lvl + (cnt2 > 1).astype(np.int64)
                    )[rmap2.parent]
                # derefine_mesh rebuilt the level from the coarse mesh,
                # invalidating the live partial groups — reset the
                # intermediates state (same convention as t0ref's
                # uniform_derefine, control/config.py apply_t0ref)
                from .multipass import AMRState

                chain.state = AMRState()
                # error field no longer matches the mesh; retag next
                # cycle (refining stale fine-level tags would fight the
                # coarsening we just did)
                return changed, mesh, chain, u

    # ---- (2) refine the current mesh ----------------------------------
    edges = gen_inpoed(mesh.inpoel)
    err = edge_errors(mesh, uerr, 0, method)
    tag = err > tol_refine
    if tag.any():
        # persistent-intermediates path (reference semantics): one
        # refine_pass over the live AMRState, with the level cap
        # enforced as pre-locked edges INSIDE the mark fixed point
        # (refinement.hpp:28); tags on intermediate-locked edges are
        # dropped at intake (mark_error_refinement,
        # mesh_adapter.cpp:134), and tagging a partial child's unlocked
        # edge re-refines the PARENT 2:8/4:8 instead of stacking
        from .multipass import (
            AMRState, refine_pass, transfer_dg_pass,
        )

        inpoel = mesh.inpoel.astype(np.int64)
        at_cap = chain.elevel >= maxlevels
        banned = None
        if at_cap.any():
            banned = np.stack(
                [inpoel[at_cap][:, _TET_EDGES[:, 0]].ravel(),
                 inpoel[at_cap][:, _TET_EDGES[:, 1]].ravel()], axis=1)
        try:
            vol_cur = None if cg_scheme else _elem_volumes(mesh)
            mesh3, rmap3, newstate = refine_pass(
                mesh, edges[tag].astype(np.int64), chain.state,
                banned=banned)
            if len(rmap3.mid_edges) or rmap3.rebuilt:
                if cg_scheme:
                    u = transfer_cg(rmap3, u)
                else:
                    u = transfer_dg_pass(rmap3, u, vol_cur, ncomp, ndof)
                okp = rmap3.parent >= 0
                src = np.maximum(rmap3.parent, 0)
                cnt3 = np.bincount(src[okp], minlength=mesh.nelem)
                new_lvl = np.zeros(len(rmap3.parent), np.int64)
                new_lvl[okp] = (chain.elevel
                                + (cnt3 > 1).astype(np.int64))[src[okp]]
                for old_rows, new_rows in (rmap3.rebuilt or []):
                    # a 2:8/4:8 rebuild keeps the children's depth
                    new_lvl[new_rows] = chain.elevel[old_rows].max()
                chain.levels.append((mesh, rmap3, chain.elevel.copy()))
                chain.elevel = new_lvl
                chain.state = newstate
                mesh = mesh3
                changed = True
            return changed, mesh, chain, u
        except AssertionError:
            # order-dependent class-2/3 interaction: fall back to the
            # single-event close-then-exclude machinery below (and drop
            # the live groups — the single-pass refiner does not track
            # them)
            chain.state = AMRState()

    tags = np.zeros((0, 2), dtype=np.int64)
    if tag.any():
        # LEVEL CAP.  Refining an edge splits EVERY incident element
        # (conforming 4:1 subdivision), so an edge is refinable only if
        # ALL its incident elements sit below maxlevels — and the
        # compatibility closure must respect that too (the reference
        # hard-caps inside its compatibility iteration by LOCKING edges
        # of at-cap elements, refinement.hpp:28).  compatible_tags only
        # upgrades (1:8), so enforce the lock by a close-then-exclude
        # fixed point: any closure that tags a capped edge has its
        # forcing elements fully untagged (the analog of the
        # reference's deactivate), and the loop re-closes.
        from .refine import compatible_tags

        keys = _edge_key(edges[:, 0], edges[:, 1])
        order = np.argsort(keys)
        ks = keys[order]
        inpoel = mesh.inpoel.astype(np.int64)
        ek = _edge_key(inpoel[:, _TET_EDGES[:, 0]],
                       inpoel[:, _TET_EDGES[:, 1]])
        pos = np.clip(np.searchsorted(ks, ek), 0, len(ks) - 1)  # (E,6)
        banned_sorted = np.zeros(len(edges), dtype=bool)
        at_cap = chain.elevel >= maxlevels
        banned_sorted[pos[at_cap].ravel()] = True  # edge touches cap elem
        allowed_sorted = ~banned_sorted
        tag = tag & allowed_sorted[np.searchsorted(ks, keys)]

        excl_sorted = np.zeros(len(edges), dtype=bool)
        cur = edges[tag].astype(np.int64)
        for _ in range(100):
            if not len(cur):
                break
            closed = compatible_tags(inpoel, cur)
            ck = _edge_key(closed[:, 0], closed[:, 1])
            cpos = np.clip(np.searchsorted(ks, ck), 0, len(ks) - 1)
            badS = ~allowed_sorted[cpos]
            if not badS.any():
                cur = closed  # closed AND cap-clean: done
                break
            # elements whose closed pattern includes a banned edge are
            # the forcing ones: permanently untag all their edges
            badk = np.sort(np.unique(ck[badS]))
            ekpos = np.clip(np.searchsorted(badk, ek), 0, len(badk) - 1)
            el_bad = (badk[ekpos] == ek).any(axis=1)  # (E,)
            nexcl0 = int(excl_sorted.sum())
            excl_sorted[pos[el_bad].ravel()] = True
            if int(excl_sorted.sum()) == nexcl0:
                # stalled: escalation reaches banned edges transitively
                # through already-excluded elements — expand the
                # exclusion by one element ring per stall (terminates:
                # the exclusion grows monotonically, bounded by E)
                el_touch = excl_sorted[pos].any(axis=1)
                excl_sorted[pos[el_touch].ravel()] = True
            keep = allowed_sorted[cpos] & ~excl_sorted[cpos]
            cur = closed[keep]
        tags = cur
    if len(tags):
        mesh3, rmap3 = refine_mesh(mesh, tags)
        if mesh3.nelem > mesh.nelem:
            if cg_scheme:
                u = transfer_cg(rmap3, u)
            else:
                u = transfer_dg(rmap3, u, ncomp, ndof)
            cnt3 = np.bincount(rmap3.parent, minlength=mesh.nelem)
            new_lvl = (
                chain.elevel + (cnt3 > 1).astype(np.int64)
            )[rmap3.parent]
            chain.levels.append((mesh, rmap3, chain.elevel.copy()))
            chain.elevel = new_lvl
            mesh = mesh3
            changed = True

    return changed, mesh, chain, u
