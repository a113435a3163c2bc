"""Command-line driver: python -m quinoa_tpu_torch inciter -c deck.q -i mesh

The port's own copy of quinoa_tpu/cli.py's single-device inciter command
(the reference's InciterDriver, src/Main/): the same flags, deck schema,
file formats and output names.  It reads the control deck and the mesh,
Hilbert-reorders the elements, builds the solver the deck names
(control.config.build_inciter), steps it, and writes the diagnostics
file, field output and checkpoints; it can restart from a checkpoint of
either package.  It runs on the card; ``main(argv, device="cpu")`` runs it
on the CPU, as the tests do.

What the port does not have yet is refused before any step, with exit
code 2 and one line naming the missing piece: the parallel options
(--npes > 1, -u > 0, --slices, --pieces > 1), particles, --trace-dir,
-H, the other subcommands, and decks that ask for mesh refinement
(t0ref, dtref).
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
    if args.particles > 0:
        return "--particles (the particle tracker)"
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
                    help="seed N passive tracer particles (not ported: "
                         "N > 0 is refused)")
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

    from .base.profiler import PhaseProfiler
    from .control.config import build_inciter, load_inciter
    from .inciter.checkpoint import load_checkpoint, save_checkpoint
    from .io import DiagWriter, read_mesh
    from .io.iothread import AsyncWriter
    from .mesh.reorder import hilbert_element_reorder

    device = resolve_device(device)
    prof = PhaseProfiler()
    with open(args.control) as fh:
        cfg = load_inciter(fh.read())
    if cfg.t0ref or cfg.dtref:
        return _refuse("mesh refinement (the deck's amr t0ref/dtref)")
    with prof.phase("mesh read"):
        mesh = read_mesh(args.input)
    if args.verbose:
        print(f"quinoa_tpu_torch inciter: {cfg.title!r}")
        print(f"  mesh: {mesh.nnode} nodes, {mesh.nelem} tets")
        print(f"  scheme={cfg.scheme} pde={cfg.pde} problem={cfg.problem}")

    # Hilbert element reorder (the reference's Sorter/Reorder analog,
    # src/Inciter/Sorter.cpp): semantically invisible; field output is
    # written back in the input file's element order through eorder
    with prof.phase("reorder"):
        mesh, eorder = hilbert_element_reorder(mesh)

    with prof.phase("solver build"):
        solver, diag = build_inciter(cfg, mesh, device=device)
        state = solver.initial_state(t0=cfg.t0)
    if args.restart:
        state, _ = load_checkpoint(args.restart, type(state),
                                   device=state.u.device,
                                   dtype=state.u.dtype)
        if args.verbose:
            print(f"  restarted from {args.restart} at it={int(state.it)} "
                  f"t={float(state.t):.6e}")
    dw = DiagWriter(args.diag, ncomp=solver.system.ncomp,
                    fmt=cfg.diag_format, precision=cfg.diag_precision)
    if args.lbfreq:
        print("  note: --lbfreq has no effect on single-device runs "
              "(load balancing needs --npes > 1)", file=sys.stderr)

    aw = AsyncWriter(enabled=not args.sync_io)

    def write_fields(it, state):
        # the host copy is taken here, on the stepping thread; the worker
        # only derives plot variables on the host and writes the file
        snap = _host_snapshot(cfg, solver, state)
        aw.submit(lambda: _write_fields(args.output, it, cfg, solver, snap,
                                        mesh, eorder=eorder))

    t0 = time.perf_counter()
    it = int(state.it)  # nonzero when restarted from a checkpoint
    with _Preempt() as pre:
        while it < cfg.nstep and float(state.t) < cfg.term:
            with prof.phase("timestep"):
                state = solver.step(state)
                # reading it back waits for the step: the phase times the
                # device's work, not only its enqueueing
                it = int(state.it)
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
            if args.verbose and it % cfg.ttyi == 0:
                print(f"  it={it} t={float(state.t):.6e} "
                      f"dt={float(state.dt):.6e}")
            if it % cfg.field_interval == 0 and not args.benchmark:
                with prof.phase("field output"):
                    write_fields(it, state)
            if (args.rsfreq and it % args.rsfreq == 0) or pre.flag:
                with prof.phase("checkpoint"):
                    save_checkpoint(args.checkpoint_dir, state,
                                    {"it": it, "t": float(state.t)})
            if pre.flag:
                print(f"  preempted at it={it}: checkpoint written to "
                      f"{args.checkpoint_dir}; resume with --restart")
                break
    dw.close()
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


#: subcommands of the JAX package's CLI the port has not ported yet
_UNPORTED_COMMANDS = ("walker", "meshconv", "rngtest", "fileconv")


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
    if not argv or argv[0] != "inciter":
        print("usage: python -m quinoa_tpu_torch inciter [options]",
              file=sys.stderr)
        return 2
    return _cmd_inciter(argv[1:], device=device)
