"""Command-line driver: python -m quinoa_tpu_torch inciter -c deck.q -i mesh
and python -m quinoa_tpu_torch walker -c deck.q

The port's own copy of quinoa_tpu/cli.py's single-device inciter and
walker commands (the reference's InciterDriver and WalkerDriver,
src/Main/): the same flags, deck schema, file formats and output names.
The inciter command reads the control deck and the mesh,
applies the deck's initial refinement passes (amr t0ref), Hilbert-reorders
the elements, builds the solver the deck names
(control.config.build_inciter), steps it, and writes the diagnostics
file, field output and checkpoints; it can restart from a checkpoint of
either package.  During the run it adapts the mesh every dtfreq steps
(amr dtref: uniform, the incremental multi-level cycle, or one level from
the base mesh with maxlevels 1), transfers the solution on the host and
rebuilds the solver on the new mesh; --particles advects tracers with the
flow and writes their H5Part trajectories.

The walker command reads a walker deck, integrates its SDE systems over
the particle ensemble and writes the moments' time series (--stat) and
the deck's PDFs, as quinoa_tpu's walker command does, drawing the same
random numbers from the same seed.

Both run on the card; ``main(argv, device="cpu")`` runs them on the CPU,
as the tests do, in torch's default float.  What the port does not have
yet is refused before any step, with exit code 2 and one line naming the
missing piece: the parallel options (--npes > 1, -u > 0, --slices,
--pieces > 1), --trace-dir, -H and the other subcommands.
"""

from __future__ import annotations

import argparse
import sys
import time

from .device import DEFAULT_DEVICE, resolve_device

_CG_SCHEMES = ("diagcg", "alecg")


class _Preempt:
    """Graceful preemption drain: SIGTERM/SIGINT set a flag; the step
    loop finishes the current iteration, writes a restart checkpoint
    and the final outputs, and exits cleanly (the reference's `-r rsfreq`
    restart contract, src/Main/Inciter.cpp): a preempted run resumes with
    `--restart`."""

    def __init__(self):
        self.flag = False
        self._old = {}

    def __enter__(self):
        import signal

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread: no handlers, no drain
                pass
        return self

    def _handler(self, signum, frame):
        import signal

        if self.flag:
            return  # already draining; original handlers restored below
        self.flag = True
        # restore the original handlers so a SECOND signal aborts a run
        # hung inside a step instead of being swallowed by the drain flag
        for sig, h in self._old.items():
            signal.signal(sig, h)

    def __exit__(self, *exc):
        import signal

        for sig, h in self._old.items():
            signal.signal(sig, h)
        return False


def _refuse(what: str) -> int:
    print(f"quinoa_tpu_torch: {what} is not ported yet", file=sys.stderr)
    return 2


def _unported_option(args) -> str | None:
    """The first option of args that names a piece the port lacks."""
    if args.npes > 1:
        return "--npes > 1 (the parallel solvers)"
    if args.virtualization > 0.0:
        return "-u (overdecomposition, part of the parallel solvers)"
    if args.slices:
        return "--slices (multi-slice partitioning, part of the parallel " \
               "solvers)"
    if args.pieces > 1:
        return "--pieces > 1 (partitioned field output, part of the " \
               "parallel solvers)"
    if args.trace_dir:
        return "--trace-dir (on-device tracing)"
    return None


def _cmd_inciter(argv, device=DEFAULT_DEVICE):
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch inciter")
    ap.add_argument("-c", "--control", required=True, help=".q control file")
    ap.add_argument("-i", "--input", required=True, help="input mesh file")
    ap.add_argument("-o", "--output", default="out",
                    help="field output basename")
    ap.add_argument("--diag", default="diag", help="diagnostics file")
    ap.add_argument("-r", "--rsfreq", type=int, default=0,
                    help="checkpoint every N steps (0 = off)")
    ap.add_argument("--restart", default=None,
                    help="restart from a checkpoint directory")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: <output>.restart "
                         "next to the field output)")
    ap.add_argument("--pieces", type=int, default=0,
                    help="write field output as N per-partition exodus "
                         "pieces (not ported: N > 1 is refused)")
    ap.add_argument("--sync-io", action="store_true",
                    help="write field output synchronously (default: a "
                         "worker thread overlaps file I/O with stepping)")
    ap.add_argument("-b", "--benchmark", action="store_true",
                    help="benchmark mode: no field output "
                         "(MeshWriter.cpp:101); diagnostics still write")
    ap.add_argument("-l", "--lbfreq", type=int, default=0,
                    help="dynamic load balancing every N steps (no effect "
                         "on one device)")
    ap.add_argument("--npes", type=int, default=1,
                    help="shard the run over N devices (not ported: N > 1 "
                         "is refused)")
    ap.add_argument("--slices", type=int, default=0,
                    help="multi-slice partitioning (not ported: refused)")
    ap.add_argument("-u", "--virtualization", type=float, default=0.0,
                    help="overdecomposition parameter in [0,1) (not "
                         "ported: > 0 is refused)")
    ap.add_argument("--particles", type=int, default=0,
                    help="seed N passive tracer particles, advect them "
                         "with the flow each step, and write "
                         "<output>.h5part trajectories (the Tracker/"
                         "H5PartWriter analog, src/Particles/"
                         "Tracker.hpp)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="print the per-phase wall-clock table at the "
                         "end (the reference Main's timer printout)")
    ap.add_argument("--trace-dir", default=None,
                    help="on-device trace directory (not ported: refused)")
    args = ap.parse_args(argv)
    what = _unported_option(args)
    if what is not None:
        return _refuse(what)
    if args.checkpoint_dir is None:
        args.checkpoint_dir = args.output + ".restart"

    import dataclasses

    import torch

    from .base.profiler import PhaseProfiler
    from .control.config import apply_t0ref, build_inciter, load_inciter
    from .inciter.checkpoint import (CheckpointMismatch, load_checkpoint,
                                     save_checkpoint)
    from .io import DiagWriter, read_mesh
    from .io.iothread import AsyncWriter
    from .mesh.reorder import hilbert_element_reorder

    device = resolve_device(device)
    prof = PhaseProfiler()
    with open(args.control) as fh:
        cfg = load_inciter(fh.read())
    with prof.phase("mesh read"):
        mesh = read_mesh(args.input)
    if args.verbose:
        print(f"quinoa_tpu_torch inciter: {cfg.title!r}")
        print(f"  mesh: {mesh.nnode} nodes, {mesh.nelem} tets")
        print(f"  scheme={cfg.scheme} pde={cfg.pde} problem={cfg.problem}")

    if cfg.t0ref and cfg.amr_initial:
        n0 = mesh.nelem
        with prof.phase("t0ref"):
            # no problem: an `initial ic` pass raises, as in the JAX CLI
            mesh = apply_t0ref(cfg, mesh)
        if args.verbose:
            print(f"  t0ref: {n0} -> {mesh.nelem} tets")

    # Hilbert element reorder (the reference's Sorter/Reorder analog,
    # src/Inciter/Sorter.cpp): semantically invisible; field output is
    # written back in the input file's element order through eorder
    with prof.phase("reorder"):
        mesh, eorder = hilbert_element_reorder(mesh)

    with prof.phase("solver build"):
        solver, diag = build_inciter(cfg, mesh, device=device)
        state = solver.initial_state(t0=cfg.t0)
    if args.restart:
        try:
            state, _ = load_checkpoint(args.restart, type(state),
                                       device=state.u.device,
                                       dtype=state.u.dtype, like=state)
        except CheckpointMismatch as e:
            print(f"quinoa_tpu_torch: {e}", file=sys.stderr)
            return 2
        if args.verbose:
            print(f"  restarted from {args.restart} at it={int(state.it)} "
                  f"t={float(state.t):.6e}")
    dw = DiagWriter(args.diag, ncomp=solver.system.ncomp,
                    fmt=cfg.diag_format, precision=cfg.diag_precision)
    if args.lbfreq:
        print("  note: --lbfreq has no effect on single-device runs "
              "(load balancing needs --npes > 1)", file=sys.stderr)

    cg_scheme = cfg.scheme in _CG_SCHEMES
    pt = _make_particle_tracking(args, cfg, mesh, solver.system, device)
    _particles_write(pt, float(state.t))
    amr_base = None  # the dtref base mesh (or multi-level chain)
    amr_rmap = None  # and its current refinement (maxlevels 1)
    aw = AsyncWriter(enabled=not args.sync_io)

    def write_fields(it, state):
        # the host copy is taken here, on the stepping thread, with the
        # solver, mesh and element order of this step (a dtref event
        # replaces them); the worker only derives plot variables on the
        # host and writes the file
        snap = _host_snapshot(cfg, solver, state)
        aw.submit(lambda sv=solver, m=mesh, eo=eorder: _write_fields(
            args.output, it, cfg, sv, snap, m, eorder=eo))

    t0 = time.perf_counter()
    it = int(state.it)  # nonzero when restarted from a checkpoint
    with _Preempt() as pre:
        while it < cfg.nstep and float(state.t) < cfg.term:
            tprev = float(state.t) if pt is not None else None
            with prof.phase("timestep"):
                state = solver.step(state)
                # reading it back waits for the step: the phase times the
                # device's work, not only its enqueueing
                it = int(state.it)
            if pt is not None:
                with prof.phase("particles"):
                    _particles_step(pt, state, tprev)
            # diagnostics before any same-step dtref remesh: the reference
            # writes the row of step `it`, then refines going into the
            # next step
            if it % cfg.diag_interval == 0:
                with prof.phase("diagnostics"):
                    row = diag.compute(state)
                    if isinstance(row, tuple):
                        l2sol, l2err, linferr = row
                        dw.write(it, float(state.t), float(state.dt), l2sol,
                                 l2err, linferr)
                    else:
                        dw.write(it, row.t, row.dt, row.l2sol, row.l2err,
                                 row.linferr)
            if cfg.dtref and cfg.dtfreq and it % cfg.dtfreq == 0 \
                    and it < cfg.nstep:
                with prof.phase("dtref"):
                    # one host copy of the solution per event
                    changed, mesh2, amr_base, amr_rmap, u2 = _dtref_remesh(
                        cfg, mesh, amr_base, amr_rmap,
                        state.u.detach().cpu().numpy(), cg_scheme,
                        solver.system.ncomp,
                        None if cg_scheme else solver.geom.ndof)
                if changed:
                    # the refined mesh is not Hilbert-reordered again, and
                    # its field output keeps the refined element order
                    mesh, eorder = mesh2, None
                    if pt is not None:
                        with prof.phase("particles"):
                            _particles_remesh(pt, mesh)
                    with prof.phase("solver build"):
                        solver, diag = build_inciter(cfg, mesh,
                                                     device=device)
                        st = solver.initial_state(t0=float(state.t))
                        state = dataclasses.replace(
                            st, u=torch.as_tensor(u2).to(
                                device=st.u.device, dtype=st.u.dtype),
                            it=state.it, dt=state.dt)
                    if args.verbose:
                        print(f"  dtref @it={it}: -> {mesh.nelem} tets")
            if args.verbose and it % cfg.ttyi == 0:
                print(f"  it={it} t={float(state.t):.6e} "
                      f"dt={float(state.dt):.6e}")
            if it % cfg.field_interval == 0 and not args.benchmark:
                with prof.phase("field output"):
                    write_fields(it, state)
                _particles_write(pt, float(state.t))
            if (args.rsfreq and it % args.rsfreq == 0) or pre.flag:
                with prof.phase("checkpoint"):
                    save_checkpoint(args.checkpoint_dir, state,
                                    {"it": it, "t": float(state.t)})
            if pre.flag:
                print(f"  preempted at it={it}: checkpoint written to "
                      f"{args.checkpoint_dir}; resume with --restart")
                break
    dw.close()
    if pt is not None:
        pt["writer"].close()
    if args.verbose:
        wall = time.perf_counter() - t0
        print(f"  done: {it} steps, t={float(state.t):.6e}, {wall:.2f}s")
    if not args.benchmark:
        # the final write and the wait for the worker's queue
        with prof.phase("field output"):
            write_fields(it, state)
            aw.close()
    aw.close()
    if args.profile:
        print(prof.table())
    return 0


def _dtref_remesh(cfg, mesh, amr_base, amr_rmap, u_host, cg_scheme, ncomp,
                  ndof):
    """One during-timestep AMR decision on the host, as the JAX CLI's.

    u_host is the solution as numpy ((C, nnode) nodal for the CG schemes,
    (C*ndof, nelem) modal for DG).  Returns (changed, mesh, amr_base,
    amr_rmap, u transferred or None): dtref_uniform refines every element
    1:8; maxlevels > 1 runs the incremental multi-level cycle
    (amr/adapt.py), whose chain rides the amr_base slot; maxlevels 1
    retags the base mesh and rebuilds one level of refinement above it.
    DG's error field is the nodal average of the cell means."""
    import numpy as np

    from .amr import refine_mesh, tag_edges_by_error, uniform_refine
    from .amr.refine import (RefineMap, transfer_cg, transfer_cg_derefine,
                             transfer_dg, transfer_dg_derefine)

    if cfg.dtref_uniform:
        # compounding uniform refinement (dtref_uniform)
        mesh2, rmap = uniform_refine(mesh)
        if mesh2.nelem > mesh.nelem:
            if cg_scheme:
                u2 = transfer_cg(rmap, u_host)
            else:
                u2 = transfer_dg(rmap, u_host, ncomp, ndof)
            return True, mesh2, amr_base, amr_rmap, u2
        return False, mesh, amr_base, amr_rmap, None

    if cfg.amr_maxlevels > 1:
        # incremental multi-level cycle: refine from the current mesh,
        # coarsen sibling groups below tol_derefine
        from .amr.adapt import dtref_adapt

        uerr = u_host if cg_scheme else _nodal_cell_means(mesh, u_host,
                                                          ncomp, ndof)
        changed, mesh2, chain, u2 = dtref_adapt(
            mesh, amr_base, uerr, u_host, cg_scheme, ncomp, ndof,
            method=cfg.amr_error, tol_refine=cfg.amr_tol,
            tol_derefine=cfg.amr_tolderef, maxlevels=cfg.amr_maxlevels,
        )
        return changed, mesh2, chain, None, (u2 if changed else None)

    # one level above the base mesh: retag every dtfreq steps and rebuild
    # refine_mesh(base, tags); regions no longer tagged coarsen (the
    # transfer between two refinements of the base is the derefine one)
    if amr_base is None:
        amr_base = mesh
        amr_rmap = RefineMap(
            mid_edges=np.zeros((0, 2), np.int64),
            parent=np.arange(mesh.nelem),
            nnode_old=mesh.nnode,
        )
    nb = amr_base.nnode  # base nodes prefix every refinement
    if cg_scheme:
        uerr = u_host[:, :nb]
        vol_cur = None
    else:
        from .mesh.geometry import tet_geometry

        uerr = _nodal_cell_means(mesh, u_host, ncomp, ndof)[:, :nb]
        J, _ = tet_geometry(mesh.coords, mesh.inpoel)
        vol_cur = J / 6.0
    tags = tag_edges_by_error(
        amr_base, uerr, method=cfg.amr_error, tol=cfg.amr_tol,
    )
    mesh2, rmap2 = refine_mesh(amr_base, tags)
    cur_keys = {tuple(e) for e in np.sort(amr_rmap.mid_edges, 1).tolist()}
    new_keys = {tuple(e) for e in np.sort(rmap2.mid_edges, 1).tolist()}
    if new_keys != cur_keys:
        if cg_scheme:
            u2 = transfer_cg_derefine(amr_rmap, rmap2, u_host)
        else:
            u2 = transfer_dg_derefine(
                amr_base, amr_rmap, rmap2, u_host, vol_cur, ncomp, ndof)
        return True, mesh2, amr_base, rmap2, u2
    return False, mesh, amr_base, amr_rmap, None


def _nodal_cell_means(mesh, u_host, ncomp, ndof):
    """(C, nnode) float64: the mean over the elements around each node of
    their cell means, summed corner by corner as the JAX CLI's np.add.at
    loops."""
    import numpy as np

    avg = u_host.reshape(ncomp, ndof, -1)[:, 0, :]   # dg_cell_avg
    unod = np.zeros((avg.shape[0], mesh.nnode))
    cnt = np.zeros(mesh.nnode)
    for a in range(4):
        np.add.at(cnt, mesh.inpoel[:, a], 1.0)
        for c in range(avg.shape[0]):
            np.add.at(unod[c], mesh.inpoel[:, a], avg[c])
    unod /= np.maximum(cnt, 1.0)
    return unod


def _particle_source(cfg, system):
    """(velocity_of, vargs of a state) by configuration: the analytic
    velocity field for transport problems, the interpolated nodal
    momentum over density for CG compflow, the containing cell's mean
    for DG compflow; SystemExit for any other pde."""
    from .particles.tracker import (analytic_velocity, cell_velocity,
                                    nodal_velocity)

    if cfg.pde == "transport":
        return analytic_velocity(system.problem), lambda state: ()
    if cfg.pde == "compflow" and cfg.scheme in _CG_SCHEMES:
        return nodal_velocity(), lambda state: (state.u,)
    if cfg.pde == "compflow":
        from .control.config import _SCHEME_NDOF

        return (cell_velocity(5, _SCHEME_NDOF.get(cfg.scheme, 4)),
                lambda state: (state.u,))
    raise SystemExit("--particles supports transport and compflow runs")


def _seed_tracking(cfg, mesh, system, npar, device):
    """{tracker, xp, ep, vargs}: npar tracers seeded as the JAX package
    seeds them, on a tracker on device in torch's default dtype (the
    solver's)."""
    import torch

    from .particles import ParticleTracker, seed_particles

    vel, vargs = _particle_source(cfg, system)
    tracker = ParticleTracker(mesh, vel, device=device)
    xp, ep = seed_particles(mesh, npar)
    g = tracker.geom
    return dict(tracker=tracker,
                xp=torch.as_tensor(xp).to(dtype=g.dtype, device=g.device),
                ep=torch.as_tensor(ep).to(dtype=torch.int64,
                                          device=g.device),
                vargs=vargs)


def _make_particle_tracking(args, cfg, mesh, system, device):
    """{tracker, xp, ep, vargs, writer} or None without --particles; the
    writer is <output>.h5part's."""
    if not args.particles:
        return None
    from .io.h5part import H5PartWriter

    pt = _seed_tracking(cfg, mesh, system, args.particles, device)
    pt["writer"] = H5PartWriter(args.output + ".h5part")
    return pt


def _particles_remesh(pt, mesh):
    """Rebuild the tracker tables on a remeshed mesh: keep the positions,
    re-home each particle at its nearest centroid (a chunk of particles
    at a time) and walk 4 x 4 hops from there, as the JAX CLI does."""
    from .particles.tracker import locate, nearest_centroid

    tr = pt["tracker"]
    tr.rebuild(mesh)
    ep = nearest_centroid(tr.geom, pt["xp"])
    for _ in range(4):
        ep = locate(tr.geom, pt["xp"], ep, hops=4)
    pt["ep"] = ep


def _particles_step(pt, state, tprev):
    pt["xp"], pt["ep"] = pt["tracker"].advance(
        pt["xp"], pt["ep"], tprev, _hs(state.dt), *pt["vargs"](state))


def _particles_write(pt, t):
    if pt is not None:
        pt["writer"].write(pt["xp"].cpu().numpy().T, time=t)


def _hs(x) -> float:
    """Host value of a time-marching scalar (a 0-d tensor or a number)."""
    import torch

    return torch.as_tensor(x).reshape(-1)[0].item()


def _host_snapshot(cfg, solver, state):
    """(u, t, exact_mean) on the host: the state's solution, its time and,
    for DG transport, the analytic solution's cell means at t."""
    u = state.u.detach().cpu()
    t = float(_hs(state.t))
    exact_mean = None
    if cfg.scheme not in _CG_SCHEMES and cfg.pde == "transport":
        from .pde.dg import dg_initialize

        ua = dg_initialize(solver.system, solver.geom, t)
        exact_mean = ua.reshape(solver.system.ncomp, solver.geom.ndof,
                                -1)[:, 0, :].cpu()
    return u, t, exact_mean


def _orig_order(mesh, elem_fields, eorder):
    """Re-express (mesh, element fields) in the original input-file
    element order (eorder is new->old from hilbert_element_reorder:
    original id of current element i is eorder[i])."""
    import numpy as np

    from .mesh.unsmesh import UnsMesh

    if eorder is None:
        return mesh, elem_fields
    inv = np.argsort(eorder)
    out = UnsMesh(coords=mesh.coords, inpoel=mesh.inpoel[inv])
    out.bface = dict(mesh.bface)
    out.bnode = mesh.bnode
    ef = elem_fields
    if elem_fields is not None:
        ef = {k: np.asarray(v)[..., inv] for k, v in elem_fields.items()}
    return out, ef


def _write_fields(base, it, cfg, solver, snap, mesh, eorder=None):
    """Write <base>.e-s.<it>.exo from a host snapshot (_host_snapshot):
    nodal plot variables for the CG schemes, cell averages (analytic
    variables sampled at centroids) for DG, in the input file's element
    order."""
    from .inciter.fieldout import plot_fields
    from .io import write_exodus

    u, t, exact_mean = snap
    fields = elem_fields = None
    if cfg.scheme in _CG_SCHEMES:
        fields = plot_fields(cfg.pde, solver.system, u, mesh.coords.T, t)
    else:
        from .pde.dg import dg_cell_avg

        avg = dg_cell_avg(u, solver.system.ncomp, solver.geom.ndof)
        cen = mesh.coords[mesh.inpoel].mean(axis=1).T
        elem_fields = plot_fields(cfg.pde, solver.system, avg, cen, t,
                                  exact_mean=exact_mean)
    mesh, elem_fields = _orig_order(mesh, elem_fields, eorder)
    write_exodus(f"{base}.e-s.{it}.exo", mesh, node_fields=fields,
                 elem_fields=elem_fields, time=t)


def _cmd_walker(argv, device=DEFAULT_DEVICE):
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch walker")
    ap.add_argument("-c", "--control", required=True)
    ap.add_argument("--stat", default="stat.txt")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default: the deck's rngs seed, or 0)")
    ap.add_argument("--npes", type=int, default=1,
                    help="shard the particle ensemble over N devices (not "
                         "ported: N > 1 is refused)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.npes > 1:
        return _refuse("--npes > 1 (the sharded walker)")

    from functools import partial

    from .control.config import build_walker, load_walker
    from .io import (TxtStatWriter, write_pdf_exodus, write_pdf_gmsh,
                     write_pdf_txt)
    from .statistics.stats import estimate_moments, moments_to_host

    with open(args.control) as fh:
        cfg = load_walker(fh.read())
    seed = args.seed if args.seed is not None else (cfg.rng_seed or 0)
    w = build_walker(cfg, seed=seed, device=resolve_device(device))
    if args.verbose:
        print(f"quinoa_tpu_torch walker: {cfg.title!r}")
        print(f"  npar={cfg.npar} dt={cfg.dt} systems="
              f"{[type(s).__name__ for s in w.systems]}")

    sw = TxtStatWriter(args.stat, cfg.ordinary, cfg.central,
                       fmt=cfg.stat_format,
                       precision=cfg.stat_precision)
    txt = (partial(write_pdf_txt, fmt=cfg.pdf_format,
                   precision=cfg.pdf_precision), "txt")
    fn, ext = {"txt": txt,
               "gmshtxt": (partial(write_pdf_gmsh,
                                   centering=cfg.pdf_centering), "msh"),
               "exodusii": (write_pdf_exodus, "exo")}.get(cfg.pdf_filetype,
                                                          txt)

    def dump_pdfs(P, t):
        for name, term, bins, extents, central in cfg.pdfs:
            pdf = w.pdf(P, term, bins, extents, central=central)
            # PDFPolicy `multiple`: time-stamped filename per output
            # (Distributor.cpp:405-411); `overwrite` (default) rewrites
            base = (f"{name}_{t:g}" if cfg.pdf_policy == "multiple"
                    else name)
            fn(f"{base}.{ext}", pdf)

    P = w.initialize()
    nsteps = min(cfg.nstep, int(cfg.term / cfg.dt + 1e-9))
    done = 0
    while done < nsteps:
        chunk = min(cfg.stat_interval, nsteps - done)
        P, _ = w.run(chunk, P=P)
        done += chunk
        mom = estimate_moments(P, w.offsets, cfg.ordinary, cfg.central)
        sw.write(done, done * cfg.dt, moments_to_host(mom))
        if cfg.pdf_interval and done % cfg.pdf_interval < cfg.stat_interval:
            dump_pdfs(P, done * cfg.dt)
        if args.verbose and done % cfg.ttyi == 0:
            print(f"  it={done} t={done * cfg.dt:.6e}")
    if cfg.pdfs:
        dump_pdfs(P, done * cfg.dt)
    sw.close()
    return 0


#: subcommands of the JAX package's CLI the port has not ported yet
_UNPORTED_COMMANDS = ("meshconv", "rngtest", "fileconv")


def main(argv=None, device=DEFAULT_DEVICE):
    """Run the command line argv (default sys.argv[1:]) on ``device``, the
    card unless the caller asks for another; returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-H" in argv or "--helpkw" in argv:
        return _refuse("-H (the control-file keyword help)")
    if "--version" in argv:
        from . import __version__

        print(f"quinoa_tpu_torch {__version__} (PyTorch + CUDA port of "
              "quinoa_tpu; hand-written sm_90a kernels)")
        return 0
    if "--license" in argv:
        print("quinoa_tpu_torch: an independent PyTorch + CUDA "
              "implementation of the Quinoa feature set.\nReference "
              "upstream (github.com/quinoacomputing/quinoa) is "
              "BSD-3-Clause.")
        return 0
    if argv and argv[0] in _UNPORTED_COMMANDS:
        return _refuse(f"the {argv[0]} command")
    if argv and argv[0] == "walker":
        return _cmd_walker(argv[1:], device=device)
    if not argv or argv[0] != "inciter":
        print("usage: python -m quinoa_tpu_torch {inciter,walker} [options]",
              file=sys.stderr)
        return 2
    return _cmd_inciter(argv[1:], device=device)
