"""Command-line driver: python -m quinoa_tpu_torch {inciter,walker,meshconv,
rngtest,fileconv} [options], and -H [keyword] for the control-file keyword
help.

The port's own copy of quinoa_tpu/cli.py's single-device commands (the
reference's InciterDriver, WalkerDriver, MeshConvDriver, RNGTestDriver and
FileConv, src/Main/): the same flags, deck schema, file formats, output
names and standard output.
The inciter command reads the control deck and the mesh,
applies the deck's initial refinement passes (amr t0ref), Hilbert-reorders
the elements, builds the solver the deck names
(control.config.build_inciter), steps it, and writes the diagnostics
file, field output and checkpoints; it can restart from a checkpoint of
either package.  During the run it adapts the mesh every dtfreq steps
(amr dtref: uniform, the incremental multi-level cycle, or one level from
the base mesh with maxlevels 1), transfers the solution on the host and
rebuilds the solver on the new mesh; --particles advects tracers with the
flow and writes their H5Part trajectories; -v prints the mesh statistics
and writes the mesh PDFs; --trace-dir records the step loop with
torch.profiler.

The walker command reads a walker deck, integrates its SDE systems over
the particle ensemble and writes the moments' time series (--stat) and
the deck's PDFs, as quinoa_tpu's walker command does, drawing the same
random numbers from the same seed.

The rngtest command runs a statistical battery (SmallCrush, Crush or
BigCrush) once per rng of its deck, drawing jax.random's Threefry streams
on the card and printing the JAX CLI's lines; meshconv converts a mesh
between formats, or joins ExodusII pieces; fileconv converts an ExodusII
field file between the classic and netCDF-4 layouts.

With --npes N (or -u V at any N) the inciter command runs the sharded
solvers (parallel/): the mesh is cut into N shards (or into
linearLoadDistributor-many chunks packed onto them), the shards step in
lockstep with the ghost and halo exchanges between them, and the
diagnostics, field output, checkpoints, dtref events and --lbfreq
rebalancing work on the gathered or per-shard fields, as in the JAX
CLI's parallel branch.  Shard s lives on card s % (number of cards): on
a machine with one card all shards share it.  --slices cuts the mesh
hierarchically, --pieces P writes P ExodusII pieces.  walker --npes N
folds its ensemble means over N equal row blocks of its one particle
tensor, in block order, as the JAX walker's sharded reduction does.

The commands run on the card; ``main(argv, device="cpu")`` runs them on
the CPU, as the tests do, in torch's default float.  The rngtest command
refuses the generators other than Threefry (--impl, and deck rngs the JAX
CLI maps to rbg).
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
                         "pieces (MeshWriter chare-group analog)")
    ap.add_argument("--sync-io", action="store_true",
                    help="write field output synchronously (default: a "
                         "worker thread overlaps file I/O with stepping)")
    ap.add_argument("-b", "--benchmark", action="store_true",
                    help="benchmark mode: no field output "
                         "(MeshWriter.cpp:101); diagnostics still write")
    ap.add_argument("-l", "--lbfreq", type=int, default=0,
                    help="dynamic load balancing every N steps: under "
                         "p-adaptive DG with --npes, repartition by "
                         "active dofs along the SFC (the Charm++ "
                         "migration / Zoltan weighted-HSFC analog)")
    ap.add_argument("--npes", type=int, default=1,
                    help="shard the run over N shards (domain "
                         "decomposition; the Transporter/Partitioner "
                         "analog); shard s runs on card s %% (cards)")
    ap.add_argument("--slices", type=int, default=0,
                    help="treat the --npes shards as N slices x "
                         "(npes/N): hierarchical partitioning keeps halo "
                         "exchanges inside a slice")
    ap.add_argument("-u", "--virtualization", type=float, default=0.0,
                    help="overdecomposition parameter in [0,1): cut "
                         "linearLoadDistributor-many chunks and pack "
                         "them onto the shards (the Charm++ "
                         "virtualization analog; LoadDistributor.cpp)")
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
                    help="record the step loop with torch.profiler (the "
                         "card's kernels too) into this directory as a "
                         "Chrome trace (Projections analog)")
    args = ap.parse_args(argv)
    if args.checkpoint_dir is None:
        args.checkpoint_dir = args.output + ".restart"

    from .base.profiler import PhaseProfiler, tracing

    prof = PhaseProfiler()
    # --profile and --trace-dir turn the program's spans and counters on,
    # nested under the command's phases
    with tracing(prof if args.profile or args.trace_dir else None):
        return _run_inciter(args, device, prof)


def _run_inciter(args, device, prof):
    import dataclasses

    import torch

    from .base.profiler import torch_trace
    from .control.config import apply_t0ref, build_inciter, load_inciter
    from .inciter.checkpoint import (CheckpointMismatch, load_checkpoint,
                                     save_checkpoint)
    from .io import DiagWriter, read_mesh
    from .io.iothread import AsyncWriter
    from .mesh.reorder import hilbert_element_reorder

    device = resolve_device(device)
    with open(args.control) as fh:
        cfg = load_inciter(fh.read())
    with prof.phase("mesh read"):
        mesh = read_mesh(args.input)
    if args.verbose:
        print(f"quinoa_tpu_torch inciter: {cfg.title!r}")
        print(f"  mesh: {mesh.nnode} nodes, {mesh.nelem} tets")
        print(f"  scheme={cfg.scheme} pde={cfg.pde} problem={cfg.problem}"
              + (f" npes={args.npes}" if args.npes > 1 else ""))

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

    if args.verbose:
        # setup-time mesh statistics echo and PDF dump
        # (Transporter::stat/pdfstat, Transporter.cpp:735-846)
        import numpy as np

        from .mesh.stats import (format_mesh_statistics, mesh_statistics,
                                 write_mesh_pdfs)

        if args.npes > 1:
            from .parallel.partition import partition_elements

            parts = partition_elements(mesh.coords, mesh.inpoel,
                                       args.npes, cfg.partitioner)
            chunks = np.bincount(parts, minlength=args.npes)
        else:
            chunks = [mesh.nelem]
        mstats = mesh_statistics(mesh, chunks)
        print(format_mesh_statistics(mstats))
        write_mesh_pdfs(mstats)

    if args.npes > 1 or args.virtualization > 0.0:
        # npes 1 with -u still runs the overdecomposed sharded path (the
        # reference's asynclogic sweep includes 1-PE virtualization)
        return _run_inciter_spmd(args, cfg, mesh, eorder, device, prof)

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
            args.output, it, cfg, sv, snap, m, pieces=args.pieces,
            eorder=eo))

    t0 = time.perf_counter()
    it = int(state.it)  # nonzero when restarted from a checkpoint
    with torch_trace(args.trace_dir, cuda=device.type == "cuda"), \
            _Preempt() as pre:
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


def _shard_devices(device):
    """The devices the shards go on: every card for a CUDA device (shard s
    on card s % count), else the one device asked for."""
    import torch

    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _run_inciter_spmd(args, cfg, mesh, eorder, device, prof):
    """The sharded inciter run, as the JAX CLI's _run_inciter_spmd
    (quinoa_tpu/cli.py:493-720): partition, sharded solver, owned-masked
    diagnostics, gathered (or per-shard) field output and sharded
    checkpoints; a dtref remesh gathers the field, remeshes, repartitions
    and rebuilds the sharded solver; --lbfreq repartitions p-adaptive DG
    by active dofs."""
    import dataclasses

    from .base.profiler import torch_trace
    from .control.config import build_inciter_spmd
    from .inciter.checkpoint import (CheckpointMismatch,
                                     load_checkpoint_sharded,
                                     save_checkpoint_sharded)
    from .io import DiagWriter
    from .io.iothread import AsyncWriter

    hierarchy = None
    if args.slices and args.slices > 1:
        if args.npes % args.slices:
            raise SystemExit("--npes must be a multiple of --slices")
        hierarchy = (args.slices, args.npes // args.slices)
    devices = _shard_devices(device)

    def build(mesh, **kw):
        with prof.phase("solver build"):
            return build_inciter_spmd(cfg, mesh, args.npes, devices=devices,
                                      hierarchy=hierarchy, **kw)

    solver = build(mesh, virtualization=args.virtualization)
    if args.verbose:
        print(f"  shards: {solver.group.placement()}")
    cg_scheme = cfg.scheme in _CG_SCHEMES

    state = solver.initial_state(t0=cfg.t0)
    if args.restart:
        try:
            state, _ = load_checkpoint_sharded(
                args.restart, type(state), solver.group.devices,
                dtype=state.u[0].dtype, like=state)
        except CheckpointMismatch as e:
            print(f"quinoa_tpu_torch: {e}", file=sys.stderr)
            return 2
        if args.verbose:
            print(f"  restarted from {args.restart} at "
                  f"it={int(_hs(state.it))}")
    dw = DiagWriter(args.diag, ncomp=solver.system.ncomp,
                    fmt=cfg.diag_format, precision=cfg.diag_precision)

    amr_base = None
    amr_rmap = None
    aw = AsyncWriter(enabled=not args.sync_io)

    def write_fields(it, state):
        # host copies of the shards, taken on the stepping thread with
        # this step's solver, mesh and element order
        snap = ([u.detach().cpu() for u in state.u], float(_hs(state.t)))
        aw.submit(lambda sv=solver, m=mesh, eo=eorder: _write_fields_spmd(
            args, it, cfg, sv, snap, m, cg_scheme, eorder=eo))

    t0 = time.perf_counter()
    it = int(_hs(state.it))
    with torch_trace(args.trace_dir, cuda=device.type == "cuda"), \
            _Preempt() as pre:
        while it < cfg.nstep and float(_hs(state.t)) < cfg.term:
            with prof.phase("timestep"):
                state = solver.step(state)
                it = int(_hs(state.it))
            if it % cfg.diag_interval == 0:
                with prof.phase("diagnostics"):
                    l2sol, l2err, linferr = solver.diagnostics(state)
                    dw.write(it, float(_hs(state.t)), float(_hs(state.dt)),
                             l2sol, l2err, linferr)
            if cfg.dtref and cfg.dtfreq and it % cfg.dtfreq == 0 \
                    and it < cfg.nstep:
                with prof.phase("dtref"):
                    # the solver that wrote the state gathers it
                    changed, mesh2, amr_base, amr_rmap, u2 = _dtref_remesh(
                        cfg, mesh, amr_base, amr_rmap,
                        solver.gather_global(state), cg_scheme,
                        solver.system.ncomp,
                        None if cg_scheme else solver.ndof)
                if changed:
                    with prof.phase("resharding"):
                        mesh, eorder = mesh2, None
                        solver = build(mesh,
                                       virtualization=args.virtualization)
                        st = solver.initial_state(t0=float(_hs(state.t)))
                        state = dataclasses.replace(
                            st, u=solver.scatter(u2, st.u), it=state.it,
                            dt=state.dt)
                    if args.verbose:
                        print(f"  dtref @it={it}: -> {mesh.nelem} tets "
                              f"(resharded over {args.npes})")
            if args.lbfreq and it % args.lbfreq == 0 and it < cfg.nstep \
                    and getattr(solver, "pref", False) and not args.slices:
                with prof.phase("load balancing"):
                    solver, state = _rebalance(args, cfg, mesh, solver,
                                               state, build)
            if args.verbose and it % cfg.ttyi == 0:
                print(f"  it={it} t={float(_hs(state.t)):.6e} "
                      f"dt={float(_hs(state.dt)):.6e}")
            if it % cfg.field_interval == 0 and not args.benchmark:
                with prof.phase("field output"):
                    write_fields(it, state)
            if (args.rsfreq and it % args.rsfreq == 0) or pre.flag:
                with prof.phase("checkpoint"):
                    save_checkpoint_sharded(
                        args.checkpoint_dir, state,
                        {"it": it, "t": float(_hs(state.t)),
                         "npes": args.npes})
            if pre.flag:
                print(f"  preempted at it={it}: checkpoint written to "
                      f"{args.checkpoint_dir}; resume with --restart")
                break
    dw.close()
    if args.verbose:
        wall = time.perf_counter() - t0
        print(f"  done: {it} steps, t={float(_hs(state.t)):.6e}, "
              f"{wall:.2f}s")
    if not args.benchmark:
        with prof.phase("field output"):
            write_fields(it, state)
            aw.close()
    aw.close()
    if args.profile:
        print(prof.table())
    return 0


def _rebalance(args, cfg, mesh, solver, state, build):
    """Dynamic load balancing by active dofs (ndofel), as the JAX CLI's
    --lbfreq (quinoa_tpu/cli.py:614-690): without -u repartition along
    the weighted SFC; under -u keep the chunks and re-pack them onto the
    shards by LPT (the chare-migration analog).  A partition (or packing)
    equal to the current one is no migration.  Migrates u and the sticky
    ndofel.  Returns (solver, state)."""
    import dataclasses

    import numpy as np

    from .parallel.partition import partition_elements

    nd = solver.gather_ndofel(state)
    virt = args.virtualization
    if virt > 0.0:
        # the signature is the chunk -> shard packing, not the raw
        # weights: ndofel drifts nearly every adaptation while the
        # packing is usually stable
        from .parallel.overdecomp import chunks_per_shard, lpt_assign
        from .parallel.partition import partition_for

        cpd = chunks_per_shard(virt, mesh.nelem, args.npes)
        nchunk = cpd * args.npes
        ep_ch = partition_for(mesh.coords, mesh.inpoel, nchunk,
                              cfg.partitioner)
        costs = np.bincount(ep_ch, weights=nd, minlength=nchunk)
        sig = lpt_assign(costs, args.npes, cpd).tobytes()
        kw = dict(virtualization=virt, elem_weights=nd.astype(np.float64))
    else:
        epart = partition_elements(mesh.coords, mesh.inpoel, args.npes,
                                   weights=nd.astype(np.float64))
        sig = epart.tobytes()
        kw = dict(epart=epart)
    if getattr(args, "_lb_sig", None) == sig:
        return solver, state
    args._lb_sig = sig
    u2 = solver.gather_global(state)
    solver = build(mesh, **kw)
    st = solver.initial_state(t0=float(_hs(state.t)))
    state = dataclasses.replace(
        st, u=solver.scatter(u2, st.u),
        ndofel=[x[0] for x in solver.scatter(nd[None], [
            n[None] for n in st.ndofel])],
        it=state.it, dt=state.dt)
    if args.verbose:
        eg, own = solver.shard_ids()
        per = [float(nd[eg[s][own[s]]].sum()) for s in range(args.npes)]
        print(f"  lb @it={int(_hs(state.it))}: active-dof balance "
              f"{min(per):.0f}..{max(per):.0f}")
    return solver, state


def _write_fields_spmd(args, it, cfg, solver, snap, mesh, cg_scheme,
                       eorder=None):
    """Field output of a sharded run from a host snapshot (the shards'
    host tensors and t): per shard or per chare pieces where --pieces asks
    for them (_write_pieces_per_shard), else the gathered field, as one
    file or --pieces pieces of the partitioned mesh."""
    from .inciter.fieldout import plot_fields

    us, t = snap
    if _write_pieces_per_shard(args, it, cfg, solver, us, t, mesh,
                               cg_scheme, eorder=eorder):
        return
    fields = elem_fields = None
    u = solver.gather(us)
    if cg_scheme:
        fields = plot_fields(cfg.pde, solver.system, u, mesh.coords.T, t)
    else:
        from .pde.dg import dg_cell_avg

        avg = dg_cell_avg(u, solver.system.ncomp, solver.ndof)
        cen = mesh.coords[mesh.inpoel].mean(axis=1).T
        elem_fields = plot_fields(cfg.pde, solver.system, avg, cen, t)
    mesh, elem_fields = _orig_order(mesh, elem_fields, eorder)
    _write_gathered(args.output, it, mesh, fields, elem_fields, t,
                    args.pieces, cfg.partitioner)


def _write_pieces_per_shard(args, it, cfg, solver, us, t, mesh, cg_scheme,
                            eorder=None):
    """One ExodusII piece per shard (--pieces == npes) or per chare
    (--pieces == cpd*npes under -u), valued from the owning shard's host
    copy without a global gather (the MeshWriter file-per-chare contract,
    MeshWriter.hpp:33-100).  The piece meshes come from the same
    partitioner calls the shard builders made.  Returns False for piece
    counts that need a gather."""
    import numpy as np

    from .inciter.fieldout import plot_fields
    from .io import write_exodus
    from .io.pieces import extract_piece, piece_path
    from .parallel.partition import partition_elements

    if args.pieces <= 1:
        return False
    ov = getattr(solver, "overdecomp", None)
    if ov is not None:
        nchunk = ov.npes * ov.cpd
        chunk_parts = partition_elements(mesh.coords, mesh.inpoel, nchunk,
                                         algorithm=cfg.partitioner)
        devof = np.empty(nchunk, dtype=np.int64)
        for d, row in enumerate(ov.assign):
            for c in row:
                devof[c] = d
        if args.pieces == nchunk:
            piece_parts = chunk_parts            # file per chare
            dev_of_piece = devof
        elif args.pieces == args.npes:
            piece_parts = devof[chunk_parts]     # file per shard
            dev_of_piece = np.arange(args.npes)
        else:
            return False
    else:
        if args.pieces != args.npes:
            return False
        piece_parts = partition_elements(mesh.coords, mesh.inpoel,
                                         args.npes,
                                         algorithm=cfg.partitioner)
        dev_of_piece = np.arange(args.npes)

    ids, owned = solver.shard_ids()

    def g2l_owned(gids_d, owned_d):
        """global id -> local position, preferring OWNED copies (ghost
        slots hold the previous stage's values after the final RK stage;
        under -u a shard may also hold several copies)."""
        g2l = {}
        for i2, g in enumerate(gids_d):
            if g >= 0 and int(g) not in g2l:
                g2l[int(g)] = i2
        for i2, g in enumerate(gids_d):
            if g >= 0 and owned_d[i2]:
                g2l[int(g)] = i2
        return g2l

    for p in range(args.pieces):
        lm, nmap, emap = extract_piece(mesh, piece_parts, p)
        d = int(dev_of_piece[p])
        u_s = us[d].numpy()  # (C, Nl) / (C*K, El)
        g2l = g2l_owned(ids[d], owned[d])
        if cg_scheme:
            pos = np.array([g2l[int(n)] for n in nmap], dtype=np.int64)
            nf = plot_fields(cfg.pde, solver.system, u_s[:, pos],
                             mesh.coords[nmap].T, t)
            ef = None
        else:
            from .pde.dg import dg_cell_avg

            pos = np.array([g2l[int(e)] for e in emap], dtype=np.int64)
            avg = dg_cell_avg(u_s, solver.system.ncomp, solver.ndof)[:, pos]
            cen = mesh.coords[mesh.inpoel[emap]].mean(axis=1).T
            ef = plot_fields(cfg.pde, solver.system, avg, cen, t)
            nf = None
        emap_out = emap if eorder is None else eorder[emap]
        write_exodus(piece_path(args.output, it, args.pieces, p), lm,
                     node_fields=nf, elem_fields=ef, time=t,
                     node_num_map=nmap, elem_num_map=emap_out)
    return True


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
    """Host value of a time-marching scalar: a 0-d tensor or a number, or
    a sharded state's list of per-shard copies (the JAX package's (S,)
    arrays), whose first is read."""
    import torch

    if isinstance(x, (list, tuple)):
        x = x[0]
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


def _write_fields(base, it, cfg, solver, snap, mesh, pieces=0,
                  eorder=None):
    """Write <base>.e-s.<it>.exo from a host snapshot (_host_snapshot):
    nodal plot variables for the CG schemes, cell averages (analytic
    variables sampled at centroids) for DG, in the input file's element
    order; with pieces > 1, that many ExodusII pieces of the partitioned
    mesh instead."""
    from .inciter.fieldout import plot_fields

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
    _write_gathered(base, it, mesh, fields, elem_fields, t, pieces,
                    cfg.partitioner)


def _write_gathered(base, it, mesh, fields, elem_fields, t, pieces,
                    partitioner):
    """One ExodusII file of a global field, or pieces > 1 pieces of it
    cut by the deck's partitioner."""
    from .io import write_exodus, write_exodus_pieces

    if pieces > 1:
        from .parallel.partition import partition_elements

        parts = partition_elements(mesh.coords, mesh.inpoel, pieces,
                                   algorithm=partitioner)
        write_exodus_pieces(base, mesh, parts, node_fields=fields,
                            elem_fields=elem_fields, time=t, it=it)
    else:
        write_exodus(f"{base}.e-s.{it}.exo", mesh, node_fields=fields,
                     elem_fields=elem_fields, time=t)


def _cmd_walker(argv, device=DEFAULT_DEVICE):
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch walker")
    ap.add_argument("-c", "--control", required=True)
    ap.add_argument("--stat", default="stat.txt")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default: the deck's rngs seed, or 0)")
    ap.add_argument("--npes", type=int, default=1,
                    help="fold the ensemble means over N row blocks of the "
                         "particles in block order, as the JAX walker's "
                         "sharded reduction (the Distributor/Collector "
                         "analog)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from functools import partial

    from .control.config import build_walker, load_walker
    from .io import (TxtStatWriter, write_pdf_exodus, write_pdf_gmsh,
                     write_pdf_txt)
    from .statistics.stats import moments_to_host

    with open(args.control) as fh:
        cfg = load_walker(fh.read())
    seed = args.seed if args.seed is not None else (cfg.rng_seed or 0)
    w = build_walker(cfg, seed=seed, device=resolve_device(device),
                     nshard=args.npes)
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
        sw.write(done, done * cfg.dt, moments_to_host(w.moments(P)))
        if cfg.pdf_interval and done % cfg.pdf_interval < cfg.stat_interval:
            dump_pdfs(P, done * cfg.dt)
        if args.verbose and done % cfg.ttyi == 0:
            print(f"  it={done} t={done * cfg.dt:.6e}")
    if cfg.pdfs:
        dump_pdfs(P, done * cfg.dt)
    sw.close()
    return 0


def _cmd_meshconv(argv):
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch meshconv")
    ap.add_argument("-i", "--input", required=True, nargs="+",
                    help="input mesh, or several exodus PIECES "
                         "(out.e-s.<it>.<N>.<p>) to join into one file")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--netcdf4", action="store_true",
                    help="write exodus output in the HDF5-based "
                         "netCDF-4 layout instead of NetCDF-3 classic")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .io import (detect_format, join_exodus_pieces, read_mesh,
                     write_exodus, write_mesh)

    fmt4 = "netcdf4" if args.netcdf4 else "classic"
    if len(args.input) > 1:
        # join partitioned pieces back into one mesh and its fields
        mesh, nf, ef, t = join_exodus_pieces(args.input)
        if args.verbose:
            print(f"meshconv: joined {len(args.input)} pieces -> "
                  f"{args.output}: {mesh.nnode} nodes, {mesh.nelem} tets, "
                  f"{len(nf)} nodal + {len(ef)} element fields")
        write_exodus(args.output, mesh, node_fields=nf or None,
                     elem_fields=ef or None, time=t, fmt=fmt4)
        return 0

    path = args.input[0]
    fmt = detect_format(path)
    mesh = read_mesh(path, fmt)
    if not mesh.bface and mesh.nelem:
        # no boundary in the input: derive the exterior surface, as the
        # reference's meshconv does (shear.exo.std grows a shell block of
        # the 16000 exterior triangles of its block-only input)
        from .mesh.derived import exterior_faces

        mesh.bface[1] = exterior_faces(mesh.inpoel, mesh.nnode)
        mesh.bnode = mesh.bnode_from_bface()
    if args.verbose:
        print(f"meshconv: {path} ({fmt}) -> {args.output}: "
              f"{mesh.nnode} nodes, {mesh.nelem} tets, "
              f"{sum(len(v) for v in mesh.bface.values())} boundary tris")
    if args.netcdf4:
        write_exodus(args.output, mesh, fmt=fmt4)
    else:
        write_mesh(args.output, mesh)
    return 0


def _rng_impl(rngname: str) -> str:
    """The JAX CLI's map from a deck rng to a jax PRNG impl: the Random123
    philox family to rbg, every other entry (r123_threefry, MKL, RNGSSE) to
    threefry2x32 (COMPONENTS.md §2.8)."""
    return "rbg" if rngname.startswith("r123_philox") else "threefry2x32"


def _cmd_rngtest(argv, device=DEFAULT_DEVICE):
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch rngtest")
    ap.add_argument("-c", "--control", default=None,
                    help=".q control file (optional; defaults to smallcrush)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="threefry2x32",
                    help="PRNG implementation (the port has threefry2x32)")
    ap.add_argument("--battery", default=None,
                    choices=["smallcrush", "crush", "bigcrush"],
                    help="battery scale (overrides the deck block)")
    args = ap.parse_args(argv)

    name = args.battery
    rngs = None  # [(deck rng name, impl, seed)]
    if args.control:
        from .control.qparser import first, parse_deck

        with open(args.control) as fh:
            tree = parse_deck(fh.read())
        rt = first(tree, "rngtest") or tree  # battery block may be at root
        if name is None:
            name = ("bigcrush" if "bigcrush" in rt else
                    "crush" if "crush" in rt else "smallcrush")
        blk = first(rt, name)
        if isinstance(blk, dict) and blk:
            # each deck rng gets the battery (testu01suite.ci: one chare
            # per (rng, test); here one battery run per rng)
            rngs = []
            for rn, opts in blk.items():
                seed = args.seed
                for row in opts if isinstance(opts, list) else []:
                    if isinstance(row, list) and len(row) >= 2 \
                            and row[0] == "seed":
                        seed = int(row[1])
                rngs.append((rn, _rng_impl(rn), seed))
    name = name or "smallcrush"
    if not rngs:
        rngs = [(args.impl, args.impl, args.seed)]
    for rn, impl, _ in rngs:
        if impl != "threefry2x32":
            print(f"quinoa_tpu_torch: rng {rn} (impl={impl}) is not ported:"
                  " the port has threefry2x32 only", file=sys.stderr)
            return 2

    from .rngtest import BigCrush, Crush, SmallCrush, run_battery

    battery = {"bigcrush": BigCrush, "crush": Crush}.get(name, SmallCrush)
    device = resolve_device(device)
    any_failed = False
    for rn, impl, seed in rngs:
        # the JAX CLI's draws: x64 off (float32 uniforms, int32 randint)
        results, failed = run_battery(seed=seed, battery=battery, impl=impl,
                                      device=device, x64=False)
        any_failed = any_failed or bool(failed)
        print(f"{name} battery, rng={rn} (impl={impl}), seed={seed}")
        for r in results:
            print(f"  {r.name:20s} p-value {r.pvalue:8.5f}  "
                  f"{'pass' if r.passed else 'FAIL'}")
        print(f"{len(results) - len(failed)}/{len(results)} tests passed")
    return 1 if any_failed else 0


def _cmd_fileconv(argv):
    """Field-file conversion (the reference's fileconv executable,
    src/Main/FileConv.cpp).  Its ROOT<->ExodusII half needs the ROOT
    library, as in the JAX package; the ExodusII side converts between the
    NetCDF-3 classic and netCDF-4/HDF5 layouts, carrying the nodal and
    element variables of the last time step."""
    ap = argparse.ArgumentParser(prog="quinoa_tpu_torch fileconv")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    with open(args.input, "rb") as fh:
        magic = fh.read(4)
    if magic not in (b"CDF\x01", b"CDF\x02", b"\x89HDF"):
        print("fileconv: ROOT field files need the ROOT library, which "
              "is not in this build; only ExodusII inputs are supported",
              file=sys.stderr)
        return 1
    from .io.exodus import (read_exodus, read_exodus_elem_fields,
                            read_exodus_fields, write_exodus)

    mesh = read_exodus(args.input)
    nnames, ntimes, nvals = read_exodus_fields(args.input)
    enames, etimes, evals = read_exodus_elem_fields(args.input)
    nf = {n: nvals[-1, i] for i, n in enumerate(nnames)} or None
    ef = {n: evals[-1, i] for i, n in enumerate(enames)} or None
    t = float(ntimes[-1]) if len(ntimes) else (
        float(etimes[-1]) if len(etimes) else 0.0)
    fmt = "classic" if magic == b"\x89HDF" else "netcdf4"
    write_exodus(args.output, mesh, node_fields=nf, elem_fields=ef,
                 time=t, fmt=fmt)
    if args.verbose:
        print(f"fileconv: {args.input} -> {args.output} ({fmt}): "
              f"{len(nnames)} nodal + {len(enames)} element fields")
    return 0


#: the commands; those given device run on it
_COMMANDS = {"inciter": _cmd_inciter, "walker": _cmd_walker,
             "rngtest": _cmd_rngtest, "meshconv": _cmd_meshconv,
             "fileconv": _cmd_fileconv}
_ON_DEVICE = ("inciter", "walker", "rngtest")


def main(argv=None, device=DEFAULT_DEVICE):
    """Run the command line argv (default sys.argv[1:]) on ``device``, the
    card unless the caller asks for another; returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-H" in argv or "--helpkw" in argv:
        # -H [keyword]: the control-file keyword help, accepted by every
        # command (HelpFactory.hpp; Keyword.hpp:90-99)
        from .control.keywords import format_keyword_help

        i = argv.index("-H" if "-H" in argv else "--helpkw")
        kw = argv[i + 1] if i + 1 < len(argv) \
            and not argv[i + 1].startswith("-") else None
        print(format_keyword_help(kw))
        return 0
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
    if not argv or argv[0] not in _COMMANDS:
        print("usage: python -m quinoa_tpu_torch "
              "{inciter|walker|meshconv|rngtest|fileconv} [options]",
              file=sys.stderr)
        return 2
    if argv[0] in _ON_DEVICE:
        return _COMMANDS[argv[0]](argv[1:], device=device)
    return _COMMANDS[argv[0]](argv[1:])
