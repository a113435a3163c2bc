"""One run of one cell: set-up, the timed window, the traced slice, the
per-layer readings and the comparison with the plain reference.

Set-up (all of it in setup_s, from the process's start): torch and the
card, the cell's files, the mesh from the seed, the port's front end
(load_inciter, hilbert_element_reorder, build_inciter, initial_state), and
the first `check_steps` steps through the window's own loop, which warm up
every shape the window uses.  Their state is kept on the host for the
comparison.  Then the window: the loop for `seconds` seconds.  With trace,
in one torch.profiler session, a slice of `trace_steps` more steps, then,
once the memory peak is read, the calls of each operation the
configuration names (program.py), whose device time is the union of their
kernels in the trace.  Last, with the program freed, the reference in
float64 on the same device: from its own initial state through
`check_steps` steps (start_*), and one step from the program's
last-but-one state (end_*), against the program's states.  The run ends
by looking for JAX or the JAX package among the loaded modules.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from . import catalog, check, meshgen, window

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "quinoa_tpu")
#: H100 SXM HBM3 bandwidth (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: timed calls of each per-layer operation; bytes filled before each to
#: evict the 50 MB L2
REPS = 7
L2_FLUSH_BYTES = 256 << 20


class NoCard(RuntimeError):
    pass


class ForbiddenModule(RuntimeError):
    pass


def _clock():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start():
    """CLOCK_BOOTTIME seconds at this process's start (/proc/self/stat
    starttime, 10 ms resolution)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    loaded = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


class Run:
    """What a per-layer metric reader (metrics/<name>.py) reads."""

    peak_bytes_per_s = HBM_BYTES_PER_S

    def __init__(self):
        self.reorder_s = self.build_s = None
        self.diag_s = []
        self.trace = None
        self.ops = {}       # op -> device ms (median of 7)
        self.shapes = {}    # op -> the shapes its bytes are counted from

    def op_ms(self, op):
        return self.ops.get(op)

    def op_bytes(self, op):
        w = catalog.work(op)
        if w is None or op not in self.shapes:
            return None
        return w.nbytes(self.shapes[op])


def _snapshot(torch, state):
    return dict(u=state.u.detach().to("cpu", torch.float64),
                t=float(state.t), dt=float(state.dt))


def _mesh(torch, mesh):
    from quinoa_tpu_torch.mesh.unsmesh import UnsMesh

    um = UnsMesh(coords=mesh["coords"], inpoel=mesh["inpoel"],
                 bface=dict(mesh["bface"]))
    um.bnode = um.bnode_from_bface()
    return um


def compare(torch, refmod, cfg, cell, mesh, device, eorder, init, start,
            before, last, control_dtype=None):
    """The compared numbers: element_map (elements the program's order puts
    elsewhere than the reference's) and, for each group of Dubiner modes
    the cell names ("compared_modes": {group: modes}), init_<group> (the
    initial states), start_<group> (after check_steps steps, each side
    from its own initial state) and end_<group> (one step from the
    program's last-but-one state).  With control_dtype, the reference
    computed in that dtype stands for the program in init, start and
    last."""
    from reference.dg import K, State

    ref = refmod.make(cfg["deck_text"], mesh, device, cfg["precision"])
    nums = {"element_map": float(np.count_nonzero(ref.eorder != eorder))
            if len(ref.eorder) == len(eorder) else float(len(ref.eorder))}
    r0 = ref.initial_state()
    if control_dtype is not None:
        dt = getattr(torch, control_dtype)
        ctl = ref.cast(dt)
        cs = State(u=r0.u.to(dt), t=0.0, dt=0.0)
        init = {"u": cs.u.to("cpu", torch.float64)}
        for _ in range(cell["check_steps"]):
            cs = ctl.step(cs)
        start = {"u": cs.u.to("cpu", torch.float64), "t": cs.t}
        cs = ctl.step(State(u=before["u"].to(device, dt), t=before["t"], dt=0.0))
        last = {"u": cs.u.to("cpu", torch.float64), "dt": cs.dt}
        del ctl, cs
    rs = r0
    for _ in range(cell["check_steps"]):
        rs = ref.step(rs)
    r1 = ref.step(State(u=before["u"].to(device), t=before["t"], dt=0.0))
    u0, us, u1 = r0.u.cpu(), rs.u.cpu(), r1.u.cpu()
    for group, modes in cell["compared_modes"].items():
        rows = check.mode_rows(last["u"].shape[0], K, modes)
        nums[f"init_{group}"] = check.scale_gap(init["u"][rows], u0[rows])
        nums[f"start_{group}"] = max(
            check.state_gap(start["u"][rows], us[rows], u0[rows]),
            check.rel_gap(start["t"], rs.t))
        nums[f"end_{group}"] = max(
            check.state_gap(last["u"][rows], u1[rows], before["u"][rows]),
            check.rel_gap(last["dt"], r1.dt))
    return nums


def time_ops(torch, ops, label, reps=REPS):
    """Run each zero-argument call of ops {name: call} `reps` times in
    turns (in order, then in reverse), each from a cold L2 (a 256 MB fill)
    on an idle card, inside label("portbench.op.<name>") with a
    synchronize before its end, after two warm-up calls each.  The device
    time of each call is read from the profiler's trace (trace.op_ms)."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    names = sorted(ops)
    for n in names:
        ops[n]()
        ops[n]()
    for r in range(reps):
        for n in names[::1 if r % 2 == 0 else -1]:
            scratch.fill_(1)
            torch.cuda.synchronize()
            with label(f"portbench.op.{n}"):
                ops[n]()
                torch.cuda.synchronize()
    del scratch


def run_cell(name, seed, seconds, trace=False, device="cuda", dims=None,
             wrap=None, control_dtype=None, log=None, trace_steps=None):
    """Run cell `name` once; returns the result dict of the last line.

    device "cpu" skips the look for a card (the tests); dims replaces the
    traffic's mesh size, trace_steps the cell's traced slice; wrap(solver) replaces the program's solver (the
    tests' planted faults); control_dtype puts the reference, computed in
    that dtype, in the program's place for every compared state
    (control.py)."""
    t_start = process_start()
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    import torch

    cell = catalog.cell(name)
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device == "cuda"
    if cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"cell {name} needs {cell['chips']} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()}")
        torch.cuda.set_device(0)
        torch.cuda.init()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dims = tuple(dims or traffic["cells"])
    mesh = meshgen.box(dims, cfg["lo"], cfg["hi"], cell["jitter"], seed)
    run = Run()
    torch.set_default_dtype(getattr(torch, cfg["precision"]))
    refmod = catalog.config_module(cfg, "reference")

    from quinoa_tpu_torch.control.config import build_inciter, load_inciter
    from quinoa_tpu_torch.io import DiagWriter
    from quinoa_tpu_torch.mesh.reorder import hilbert_element_reorder

    pcfg = load_inciter(cfg["deck_text"])
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        t0 = time.perf_counter()
        pmesh, eorder = hilbert_element_reorder(_mesh(torch, mesh))
        run.reorder_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver, diag = build_inciter(pcfg, pmesh, device=device)
        state = solver.initial_state(t0=pcfg.t0)
        sync()
        run.build_s = time.perf_counter() - t0
        del pmesh
        init = _snapshot(torch, state)
        if wrap is not None:
            solver = wrap(solver)
        writer = DiagWriter(os.path.join(tmp, "diag"),
                            ncomp=solver.system.ncomp, fmt=pcfg.diag_format,
                            precision=pcfg.diag_precision)
        loop = window.Loop(solver, diag, writer, pcfg.diag_interval)
        _, state, _, _ = loop.run(state, steps=cell["check_steps"])
        start = _snapshot(torch, state)
        loop.diag_s.clear()
        sync()
        setup_s = _clock() - t_start
        log(f"setup {setup_s:.3f} s (reorder {run.reorder_s} s, build "
            f"{run.build_s} s); window {seconds} s")

        prev, state, times, wall = loop.run(state, seconds=seconds)
        run.diag_s = list(loop.diag_s)
        log(f"window {wall:.6f} s, {len(times)} steps, step ms median "
            f"{1e3 * statistics.median(times):.6f} p95 "
            f"{1e3 * float(np.percentile(times, 95)):.6f}, dof/s "
            f"{state.u.numel() * len(times) / wall:.6e}, t {float(state.t)!r}")
        peak = 0
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from . import trace as tr

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            loop.label = record_function
            with profile(activities=acts) as prof:
                with record_function("portbench.slice"):
                    t0 = time.perf_counter()
                    prev, state, ttimes, _ = loop.run(
                        state, steps=trace_steps or cell["trace_steps"])
                    sync()
                    twall = time.perf_counter() - t0
                loop.label = None
                if cuda:
                    peak = torch.cuda.max_memory_allocated()
                    ops = catalog.config_module(cfg, "program").ops(solver, state)
                    run.shapes = {n: v[1] for n, v in ops.items()}
                    time_ops(torch, {n: v[0] for n, v in ops.items()},
                             record_function)
                    del ops
            run.trace = tr.reduce(prof, len(ttimes), twall)
            del prof
            log("device events placed by the {} timeline (slice), the {} "
                "timeline (operations)".format(*run.trace["placed_by"]))
            for k, v in run.trace["kernels"]:
                log(f"kernel {v / len(ttimes) * 1e3:.6f} ms/step {k}")
            for n, (med, lo, hi) in sorted(run.trace["ops"].items()):
                run.ops[n] = med
                log(f"op {n} {med:.6f} ms of kernels (min {lo:.6f}, max "
                    f"{hi:.6f}), {run.op_bytes(n)} bytes counted")
        elif cuda:
            peak = torch.cuda.max_memory_allocated()
        steps, numel = len(times), state.u.numel()
        last, before = _snapshot(torch, state), _snapshot(torch, prev)
        writer.close()
        del solver, diag, state, prev, loop, writer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the reference, in float64, after the program is gone
    t0 = time.perf_counter()
    nums = compare(torch, refmod, cfg, cell, mesh, device, eorder, init, start,
                   before, last, control_dtype)
    correct, lines = check.verdict(nums, cell["limits"])
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    for k in sorted(set(nums) - set(cell["limits"])):
        log(f"reading {k} {nums[k]!r} (no limit)")

    finite = bool(np.isfinite(last["u"].numpy()).all())
    result = {"correct": correct, "attempted": steps,
              "failed": 0 if finite else steps}
    if trace:
        readers = catalog.metric_readers()
        metrics = {}
        for mname, mod in readers.items():
            v = mod.read(run)
            if v is not None:
                metrics[mname] = {"value": v, "unit": mod.UNIT}
        result["metrics"] = metrics
    else:
        result["metrics"] = {
            "dof_updates_per_s": {"value": numel * steps / wall,
                                  "unit": "dof/s"},
            "step_ms_p95": {"value": 1e3 * float(np.percentile(times, 95)),
                            "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["device"] = dev
    result["checks"] = {k: {"value": nums.get(k), "limit": v}
                        for k, v in cell["limits"].items()}
    for line in lines:
        log(line)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModule(f"loaded by the end of the run: {bad}")
    return result
