#!/usr/bin/env python3
"""A/B device times of the kernels K1 limit_vol, K12 face_wflux, K13
basis_accum, K14 mm_face_wflux, K7 alecg_vol, K8 alecg_edge, K9
cg_assemble and K11 node_assemble on one NVIDIA GPU:

    python3 kernel_ab.py [--kernels [K,...]] [--paths [P,...]] [--sass]
                         [NAME=DIR ...]

Each DIR holds a version of the sources in SOURCES beside the common.cuh
they include (for example another commit's quinoa_tpu_torch/csrc, or an
edited copy of this checkout's, in a directory that .gitignore lists).
The sources of a DIR that differ from this checkout's are built with the
package's nvcc flags into quinoa_tpu_torch/build/ab/NAME/ (all at once,
with the ptxas report of registers and spills printed), and the version
called NAME takes those kernels from them and everything else from this
checkout's library ("this", whose own report is printed first).

--kernels picks the kernels (default: all of SOURCES; an empty list:
none).  At every instance of them on the port's paths, float32 at 48^3
(P2 at 32^3) on the states chip_smoke.py checks them on: K1 on p1's
perturbed and initial Sedov states (whose smooth regions take no
Superbee branch) and on p1_lf's perturbed Sod state; K12 with HLLC at P0
(p0's perturbed Sod state), at P1 on p1's limited Sedov state and on the
face-pass input of pdg's first stage, at P2 (p2's TaylorGreen state),
with Lax-Friedrichs at P1 (p1_lf's limited state) and, for its bits
only, at P2; K14 at nmat 2/3, P0/P1, with and without THINC; K13 at its
seven (R, K) shapes; K7, K8, K9 and K11 at every instance the CG paths
launch, on the inputs the first stage of the path's solver hands them
(K7 and K8 in both flavours: alecg's transport at 1 row, alecg_cf's
Euler at 5 rows, 48^3; K9 at the same two; K11: the rhs + diffusion
sums, the P sums + Q maxima and the limited A sums of diagcg at 64^3 and
of diagcg_cf at 48^3), and K7 and K8 for their bits only on SlotCyl with
three components at 48^3 and on chip_smoke's float64 meshes, the ragged
ALECG_TAIL box included.  A version whose K7 transport still reads its
velocity per corner (the sources before it read it per node) gets the
same node velocities gathered to the corners.  Each version's kernel is
held against the plain version bit for bit (NaN where the plain version
has NaN), then all versions are timed in turns with chip_smoke.device_ms
(device time of the kernel alone, each call from a cold L2; median
[min-max] of REPS), beside the bound (chip_smoke's rule) and, in the
same turns, one torch copy that reads and writes as many bytes as the
bound counts (what the card reaches on streaming bytes alone under the
same timing).  --paths runs the named paths (all of PATHS without a
list) 1 + 10 steps with each version in turns (first to last, then back;
"this" twice when it is the only one), with their launch counts checked
and a digest of the state they reach (runs that are bit-identical, in
one checkout or two, print the same); the PROFILED paths then run 5
steps under torch.profiler (chip_smoke.profile_path: launches, device
busy and idle a step, the largest kernels), mm_p1 and mm_thinc print
their stage breakdown (chip_smoke.mm_breakdown).  With --sass, each
version's float32 instances of the chosen kernels first print their SASS
size, global loads and the median distance from a load to its first use
(cuobjdump).  The routing between kernels is Python, so a change of it
is compared by running this script with --kernels and no version from
two checkouts in turns (another commit's chip_smoke.py and package
beside a copy of this script).  Needs nvcc."""

import argparse
import ctypes
import filecmp
import hashlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("limit_vol", "face_wflux", "basis_accum", "mm_face_wflux",
           "alecg_vol", "alecg_edge", "cg_assemble", "node_assemble")
#: the C entry points (qtk_<entry>_f32/_f64) of a source, where they are
#: not the source's own name
ENTRIES = {"alecg_vol": ("alecg_vol_node", "alecg_vol_cf"),
           "alecg_edge": ("alecg_edge", "alecg_edge_cf")}
#: K7 transport's entry and argument types while it read its velocity per
#: corner, (4, R, 3, E): u, inpoelT, grad, w, vel, cv, R, N, E, stream
CORNER_VEL = ("alecg_vol", [ctypes.c_void_p] * 6 + [ctypes.c_int] +
              [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
PATHS = ("p1", "pdg", "p0", "mm_p0", "mm_p1", "p1_lf", "mm_thinc", "p2",
         "alecg", "alecg_cf", "diagcg", "diagcg_cf")
PROFILED = ("p1", "pdg", "p1_lf", "p0", "p2", "alecg", "alecg_cf", "diagcg",
            "diagcg_cf")
#: the K11 calls of a DiagCG + FCT step, in order (inciter/diagcg.py)
NODE_ASSEMBLE_CALLS = ("rhs + diffusion sums", "P sums + Q maxima",
                       "limited A sums")


def kernel_pattern(srcs):
    """A regex of the mangled names of the kernels of the sources srcs
    (a kernel's name starts with its source's: the length digit before
    it keeps face_wflux from matching mm_face_wflux)."""
    return re.compile(r"\d(" + "|".join(srcs) + r")_\w*kernelI")


def ptxas_lines(log, srcs):
    """(kernel, report line) of the ptxas report log for the kernels of
    the sources srcs: registers, shared memory and spills."""
    entry, pattern = "", kernel_pattern(srcs)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1].split("EEv")[0] + "EE"
        elif (("registers" in line or "spill" in line)
              and pattern.search(entry)):
            yield entry, line.strip()


def build_versions(kernels, dirs, srcs):
    """{name: {source: .so path}} of the sources srcs in each dir that
    differ from this checkout's, compiled at once; prints the ptxas
    report."""
    def same(a, b):
        return filecmp.cmp(a, b, shallow=False)

    jobs = []
    for name, d in dirs.items():
        out_dir = os.path.join(kernels.BUILD_DIR, "ab", name)
        os.makedirs(out_dir, exist_ok=True)
        common = same(os.path.join(d, "common.cuh"),
                      os.path.join(kernels.CSRC, "common.cuh"))
        for src in srcs:
            cu = os.path.join(d, f"{src}.cu")
            if common and same(cu, os.path.join(kernels.CSRC, f"{src}.cu")):
                continue
            so = os.path.join(out_dir, f"lib{src}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so,
                   cu]
            jobs.append((name, src, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = {name: {} for name in dirs}
    for name, src, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}/{src}.cu:\n"
                               f"{log[-4000:]}")
        for entry, line in ptxas_lines(log, (src,)):
            print(f"[build] {name} {entry}: {line}", flush=True)
        out[name][src] = so
    return out


class Library:
    """The checkout's kernel library with some entry points taken from
    other libraries (same C interface).  ``corner_vel`` holds the other
    library's per-corner K7 transport entries, by suffix, where it has
    those instead of the node-velocity ones."""

    def __init__(self, base, sos):
        self.base, self.fns, self.corner_vel = base, {}, {}
        for src, so in sos.items():
            lib = ctypes.CDLL(so)
            for entry in ENTRIES.get(src, (src,)):
                for sfx in ("f32", "f64"):
                    sym = f"qtk_{entry}_{sfx}"
                    if entry == "alecg_vol_node" and not hasattr(lib, sym):
                        fn = getattr(lib, f"qtk_{CORNER_VEL[0]}_{sfx}")
                        fn.argtypes = CORNER_VEL[1]
                        self.corner_vel[sfx] = fn
                    else:
                        fn = getattr(lib, sym)
                        fn.argtypes = getattr(base, sym).argtypes
                        self.fns[sym] = fn
                    fn.restype = ctypes.c_int

    def __getattr__(self, sym):
        return self.fns[sym] if sym in self.fns else getattr(self.base, sym)


def load_to_use(kernels, so, srcs):
    """{kernel: (instructions, global loads, median instructions from a
    load to the first instruction that reads its register)} of the float32
    instances of the sources srcs in the library so, from cuobjdump's SASS:
    the code's size, and how far ptxas hoists each load ahead of its use,
    i.e. how many loads a thread keeps in flight."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    pattern = kernel_pattern(srcs)
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not (pattern.search(name) and "kernelIf" in name):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+(.*?);", part)
        dist = []
        for i, text in enumerate(ins):
            m = re.search(r"LDG\S*\s+(R\d+),", text)
            if m is None:
                continue
            for j in range(i + 1, len(ins)):
                if m.group(1) in re.split(r"[ ,\[\]]+", ins[j])[2:]:
                    dist.append(j - i)
                    break
        dist.sort()
        out[name.split("EEv")[0] + "EE"] = (
            len(ins), len(dist), dist[len(dist) // 2] if dist else None)
    return out


def pdg_face_inputs(solver):
    """The state and volume term pdg's first step hands its first stage's
    face pass (K12 + K13): the p-adaptive Superbee limit of the initial
    state, masked by its dofs."""
    from quinoa_tpu_torch.inciter import dg

    seen = []
    face_pass = dg.fused_face_pass

    def spy(system, g, uf, vol_rhs):
        seen.append((uf, vol_rhs))
        return face_pass(system, g, uf, vol_rhs=vol_rhs)

    # the face pass the route's stage calls (inciter/dg.py)
    dg.fused_face_pass = spy
    try:
        solver.step(solver.initial_state())
    finally:
        dg.fused_face_pass = face_pass
    return seen[0]


def route_corner_velocity(kernels, torch):
    """Route kernels.alecg_vol (K7 transport) to the library in use: its
    own wrapper, or, for a library whose K7 reads per-corner velocity rows,
    that entry on the node rows gathered to the corners once (counted
    under alecg_vol as the wrapper counts)."""
    node_vol, corner = kernels.alecg_vol, {}

    def alecg_vol(u, inpoelT, grad, w, vel):
        fn = getattr(kernels._lib, "corner_vel", {}).get(
            kernels._suffix(u.dtype))
        if fn is None:
            return node_vol(u, inpoelT, grad, w, vel)
        (R, N), E = u.shape, inpoelT.shape[1]
        key = (vel.data_ptr(), inpoelT.data_ptr(), R)
        if key not in corner:
            corner[key] = vel[:, :, inpoelT.long()].permute(
                2, 0, 1, 3).expand(4, R, 3, E).contiguous()
        cv = torch.empty((R, E), dtype=u.dtype, device=u.device)
        ptr = [ctypes.c_void_p(t.data_ptr())
               for t in (u, inpoelT, grad, w, corner[key], cv)]
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(*ptr, R, N, E, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"per-corner alecg_vol failed with CUDA "
                               f"error {err}")
        kernels.launches["alecg_vol"] += 1
        return cv

    kernels.alecg_vol = alecg_vol


def step_calls(solver, kernels, entry):
    """The arguments of every call of kernels.<entry> (K7, K8, K9 or K11)
    in the first step of solver, from its initial state."""
    seen = []
    launch = getattr(kernels, entry)

    def spy(*args):
        seen.append(args)
        return launch(*args)

    setattr(kernels, entry, spy)
    try:
        solver.step(solver.initial_state())
    finally:
        setattr(kernels, entry, launch)
    return seen


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    ap.add_argument("versions", nargs="*", help="NAME=DIR")
    ap.add_argument("--kernels", nargs="?", const="",
                    default=",".join(SOURCES),
                    help="comma-separated sources of SOURCES (none without "
                    "a list)")
    ap.add_argument("--paths", nargs="?", const=",".join(PATHS), default="",
                    help="comma-separated paths of PATHS (all without a "
                    "list)")
    ap.add_argument("--sass", action="store_true",
                    help="print each version's SASS size and load-to-use "
                    "distances")
    args = ap.parse_args()
    srcs = tuple(s for s in args.kernels.split(",") if s)
    paths = tuple(p for p in args.paths.split(",") if p)
    for s in srcs:
        if s not in SOURCES:
            raise SystemExit(f"kernel_ab: no kernel {s!r} in {SOURCES}")
    for p in paths:
        if p not in PATHS:
            raise SystemExit(f"kernel_ab: no path {p!r} in {PATHS}")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                                 face_wflux_plain,
                                                 mm_face_wflux_plain)
    from quinoa_tpu_torch.ops.nbr_bounds import limit_vol_plain
    from quinoa_tpu_torch.pde.dg import BC_SYMMETRY, volume_rhs
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.problems import SedovBlastwave, TaylorGreen

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = dict(v.split("=", 1) for v in args.versions)
    base = kernels.build()
    for entry, line in ptxas_lines(kernels.build_log(), srcs):
        print(f"[build] this {entry}: {line}", flush=True)
    libs = {"this": base}
    sos = {"this": [kernels.library_path()]}
    for name, built in build_versions(kernels, dirs, srcs).items():
        libs[name] = Library(base, built)
        sos[name] = list(built.values())
    names = list(libs)
    route_corner_velocity(kernels, torch)
    if args.sass:
        for name in names:
            for so in sos[name]:
                for fn, (i, n, d) in load_to_use(kernels, so,
                                                 srcs).items():
                    print(f"[sass] {name} {fn}: {i} instructions, {n} global"
                          f" loads, median load-to-use {d} instructions",
                          flush=True)

    def use(name):
        kernels._lib = libs[name]

    dev, f32 = torch.device("cuda", 0), torch.float32
    sedov = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    taylor = DGCompFlow(TaylorGreen(), riemann_flux="hllc")
    geoms, solvers = {}, {}

    def geom(name):
        """The 48^3 (P2: 32^3) geometry path `name` runs on, built once."""
        key = {"p1": "sedov", "pdg": "sedov", "mm_p0": "p0",
               "p1_lf": "mm_p1"}.get(name, name)
        if key not in geoms:
            if key == "sedov":
                geoms[key] = cs.box_geom((cs.N_BIG,) * 3, BC_SYMMETRY, f32,
                                         dev)
            elif key == "p2":
                geoms[key] = cs.p2_geom((cs.N_P2,) * 3, f32, dev)
            else:
                geoms[key] = cs.mm_geom(key, (cs.N_BIG,) * 3, f32, dev)
        return geoms[key]

    def solver(name):
        """chip_smoke.py's solver of path `name`, built once."""
        if name not in solvers:
            if name in cs.ALECG:
                solvers[name] = cs.alecg_solver(name, (cs.N_BIG,) * 3, f32,
                                                dev)
            elif name in cs.DIAGCG:
                solvers[name] = cs.diagcg_solver(name, f32, dev)
            elif name in ("p1", "pdg"):
                solvers[name] = DGSolver(sedov, geom(name), cfl=0.5,
                                         limiter="superbeep1",
                                         pref=name == "pdg")
            elif name == "p2":
                solvers[name] = DGSolver(taylor, geom(name), cfl=0.5,
                                         limiter=None)
            else:
                solvers[name] = cs.mm_solver(name, geom(name))
        return solvers[name]

    def timed(label, kf, pf, inputs, ops, bits_only=False):
        want = pf()
        for n in names:
            use(n)
            if not cs.bit_identical(kf(), want):
                raise AssertionError(f"{label}: {n}'s kernel differs from "
                                     "the plain version")
        if bits_only:
            use("this")
            nans = sum(int(w.isnan().sum()) for w in want)
            cs.phase("ab", f"{label}: every version bit-identical to the "
                     f"plain version ({nans} NaN matched); not timed")
            return want
        got = kf()
        b = cs.nbytes(*inputs, *got)
        bound = max(1e3 * b / cs.HBM_BYTES_PER_S, 1e3 * ops / cs.F32_OPS_PER_S)
        # yardstick: one device copy that reads and writes b bytes in all
        src = torch.empty(b // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        times = cs.device_ms(torch, [lambda n=n: (use(n), kf())
                                     for n in names] + [lambda: dst.copy_(src)])
        use("this")
        copy = times.pop()
        cs.phase("ab", f"{label}: bit-identical to the plain version; " +
                 ", ".join(f"{n} {cs.spread(t)} ({100 * bound / t[0]:.1f}% "
                           "of bound)" for n, t in zip(names, times)) +
                 f"; bound {bound:.4f} ms ({b} bytes); a copy of as many "
                 f"bytes {cs.spread(copy)}; "
                 f"{names[0]}/{names[-1]} {times[0][0] / times[-1][0]:.3f}")
        return want

    # K1 on p1's perturbed and initial Sedov states and on p1_lf's state
    U1 = None
    if "limit_vol" in srcs or "face_wflux" in srcs:
        U1 = torch.as_tensor(cs.perturbed_state(geom("p1").nelem, 7)).to(
            f32).to(dev)
    if "limit_vol" in srcs:
        lf = solver("p1_lf")
        for label, sy, g, U in (("p1", sedov, geom("p1"), U1),
                                ("p1 initial state", sedov, geom("p1"),
                                 solver("p1").initial_state().u),
                                ("p1_lf", lf.system, lf.geom,
                                 cs.sod_perturbed(torch, lf))):
            vole = g.vol * g.emask
            timed(f"K1 {label} E={g.nelem}",
                  lambda: kernels.limit_vol(U, g.esuelT, g.jacInv, vole,
                                            g.ktab, 2.0, sy.eos),
                  lambda: limit_vol_plain(sy, g, U),
                  (U, g.esuelT, g.jacInv, vole, g.ktab),
                  cs.OPS["limit_vol"] * g.nelem)

    # K12 at each of its instances on the paths, Lax-Friedrichs at P2 for
    # its bits only
    if "face_wflux" in srcs:
        p0, lf, p2 = solver("p0"), solver("p1_lf"), solver("p2")
        g1 = geom("p1")
        Up0 = torch.as_tensor(cs.perturbed_state(p0.geom.nelem, 23,
                                                 K=1)).to(f32).to(dev)
        ulf, _ = limit_vol_plain(lf.system, lf.geom,
                                 cs.sod_perturbed(torch, lf))
        U2 = p2.initial_state().u
        taylor_lf = DGCompFlow(TaylorGreen(), riemann_flux="laxfriedrichs")
        cases = (("HLLC P0 p0", p0.system, p0.geom, Up0, False),
                 ("HLLC P1 p1", sedov, g1, limit_vol_plain(sedov, g1, U1)[0],
                  False),
                 ("HLLC P1 pdg", sedov, g1,
                  pdg_face_inputs(solver("pdg"))[0], False),
                 ("LF P1 p1_lf", lf.system, lf.geom, ulf, False),
                 ("HLLC P2 p2", taylor, p2.geom, U2, False),
                 ("LF P2", taylor_lf, p2.geom, U2, True))
        for label, sy, g, U, bits_only in cases:
            xi = (g.xi_l, g.xi_r) if g.ndof > 1 else ()
            timed(f"K12 {label} E={g.nelem} F={g.nface}",
                  lambda: kernels.face_wflux(
                      U, g.el, g.er, g.fn, g.farea, g.fmask, g.xi_l, g.xi_r,
                      g.bctype, g.w_face, sy.eos, sy.riemann_flux),
                  lambda: face_wflux_plain(sy, g, U),
                  (U, g.el, g.er, g.fn, g.farea, g.fmask, *xi, g.bctype,
                   g.w_face), cs.OPS["face_wflux"][g.ndof] * g.nface,
                  bits_only)

    if "mm_face_wflux" in srcs or "basis_accum" in srcs:
        # K14 (and the K13 instances after it) on chip_smoke's multimat
        # states
        cases = (("K14 (2, 1)", solver("mm_p0"), False),
                 ("K14 (3, 1)", cs.mm_solver("mm_p0", geom("p0"), nmat=3),
                  False),
                 ("K14 (2, 4)", solver("mm_p1"), False),
                 ("K14 (3, 4)", solver("mm_thinc"), False),
                 ("K14-THINC (2, 4)",
                  cs.mm_solver("mm_thinc", geom("mm_thinc"), nmat=2), True),
                 ("K14-THINC (3, 4)", solver("mm_thinc"), True))

        def k13(label, g, wfl, mx, R, K):
            xi = (g.xi_l, g.xi_r) if K > 1 else ()
            timed(f"K13 ({R}, {K}) E={g.nelem}{label}",
                  lambda: kernels.basis_accum(wfl, mx, g.fose, g.fsideR,
                                              g.xi_l, g.xi_r, K),
                  lambda: basis_accum_plain(g, wfl, mx),
                  (wfl, mx, g.fose, g.fsideR, *xi),
                  cs.OPS["basis_accum"][R, K] * g.nelem)

        flux = {}
        for label, ms, thinc in cases:
            sy, g = ms.system, ms.geom
            K, nmat, R = g.ndof, sy.nmat, sy.nrows
            U = cs.mm_perturbed(torch, ms)
            X = (sy.thinc_carriers(g, U.reshape(sy.ncomp, K, -1)) if thinc
                 else None)
            xi = (g.xi_l, g.xi_r) if K > 1 else ()
            name = "mm_face_wflux_thinc" if thinc else "mm_face_wflux"
            wfl, mx = timed(
                f"{label} E={g.nelem} F={g.nface}",
                lambda: kernels.mm_face_wflux(
                    U, g.el, g.er, g.fn, g.farea, g.fmask, g.xi_l, g.xi_r,
                    g.bctype, g.w_face, sy.eos, X, sy.thinc_beta),
                lambda: mm_face_wflux_plain(sy, g, U, X),
                (U, g.el, g.er, g.fn, g.farea, g.fmask, *xi, g.bctype,
                 g.w_face, *([X] if thinc else [])),
                cs.OPS[name][nmat, K] * g.nface)
            if label in ("K14 (2, 1)", "K14 (3, 1)", "K14 (2, 4)",
                         "K14-THINC (3, 4)"):
                k13("", g, wfl, mx, R, K)
                flux[R, K] = g, wfl, mx
        # (16, 4) and (22, 4) on each other's flux values and geometry:
        # the THINC flux's first 16 rows, and mm_p1's 16 rows with their
        # first 6 again, to tell a gap between the two shapes from one in
        # their data
        (g16, w16, m16), (g22, w22, m22) = flux[16, 4], flux[22, 4]
        k13(" on the THINC flux's first 16 rows", g22, w22[:48], m22, 16, 4)
        k13(" on mm_p1's flux rows 0-15, 0-5", g16,
            torch.cat([w16, w16[:18]]), m16, 22, 4)

        # K13 at five rows: p0 (K = 1), p1_lf (K = 4), p2 (K = 10)
        p0, lf, p2 = solver("p0"), solver("p1_lf"), solver("p2")
        Up0 = torch.as_tensor(cs.perturbed_state(p0.geom.nelem, 23,
                                                 K=1)).to(f32).to(dev)
        ulf, rvlf = limit_vol_plain(lf.system, lf.geom,
                                    cs.sod_perturbed(torch, lf))
        U2 = p2.initial_state().u
        for s, U, rv in ((p0, Up0, None), (lf, ulf, rvlf),
                         (p2, U2, volume_rhs(taylor, p2.geom, U2))):
            g, K = s.geom, s.geom.ndof
            wfl, mx = face_wflux_plain(s.system, g, U)
            xi = (g.xi_l, g.xi_r) if K > 1 else ()
            timed(f"K13 (5, {K}) E={g.nelem}",
                  lambda: kernels.basis_accum(wfl, mx, g.fose, g.fsideR,
                                              g.xi_l, g.xi_r, K, rv),
                  lambda: basis_accum_plain(g, wfl, mx, rv),
                  tuple(t for t in (wfl, mx, g.fose, g.fsideR, *xi, rv)
                        if t is not None),
                  cs.OPS["basis_accum"][5, K] * g.nelem)

    # K7 and K8 on alecg's and alecg_cf's first stage; their bits on
    # SlotCyl with three rows and on the float64 meshes
    if "alecg_vol" in srcs or "alecg_edge" in srcs:
        from quinoa_tpu_torch.ops.alecg_fused import (alecg_edge_plain,
                                                      alecg_vol_plain)
        cases = [(name, solver(name), False) for name in cs.ALECG]
        cases.append(("alecg ncomp 3", cs.alecg_solver(
            "alecg", (cs.N_BIG,) * 3, f32, dev, ncomp=3), True))
        for name in cs.ALECG:
            for n in (cs.ALECG_SMALL[name][0], cs.ALECG_TAIL):
                cases.append((f"{name} {n} float64", cs.alecg_solver(
                    name, n, torch.float64, dev), True))
        for label, s, bits_only in cases:
            sy, g, e, rows = s.system, s.geom, s.edget, s.rows
            sfx = "" if sy.flavour == "transport" else "_cf"
            u = s.initial_state().u
            R, N, E, nE = u.shape[0], g.nnode, g.nelem, e.edges.shape[1]
            shape = f"N={N} E={E} nE={nE} rows={R}"
            if "alecg_vol" in srcs:
                args = step_calls(s, kernels, "alecg_vol" + sfx)[0]
                if sfx:
                    kf = lambda: (kernels.alecg_vol_cf(*args),)
                    ops = cs.OPS["alecg_vol_cf"] * E
                else:
                    kf = lambda: (kernels.alecg_vol(*args),)
                    ops = cs.OPS["alecg_vol_row"] * R * E
                timed(f"K7{sfx} {label} {shape}", kf,
                      lambda: (alecg_vol_plain(sy, g, rows, args[0]),),
                      [a for a in args if isinstance(a, torch.Tensor)], ops,
                      bits_only)
            if "alecg_edge" in srcs:
                args = step_calls(s, kernels, "alecg_edge" + sfx)[0]
                ops = (cs.OPS["alecg_edge_cf"] if sfx
                       else cs.OPS["alecg_edge_row"] * R) * nE
                timed(f"K8{sfx} {label} {shape}",
                      lambda: (getattr(kernels, "alecg_edge" + sfx)(*args),),
                      lambda: (alecg_edge_plain(sy, e, rows, args[0]),),
                      [a for a in args if isinstance(a, torch.Tensor)], ops,
                      bits_only)

    # K9 on alecg's and alecg_cf's first stage, K11 at the three calls of
    # a diagcg and a diagcg_cf step
    if "cg_assemble" in srcs:
        from quinoa_tpu_torch.ops.alecg_fused import cg_assemble_plain
        for name in cs.ALECG:
            cv, d, nsup, ensup = step_calls(solver(name), kernels,
                                            "cg_assemble")[0]
            R, N = cv.shape[0], nsup.shape[1]
            slots = (nsup.shape[0] + ensup.shape[0]) * N
            timed(f"K9 {name} N={N} rows={R}",
                  lambda: (kernels.cg_assemble(cv, d, nsup, ensup),),
                  lambda: (cg_assemble_plain(cv, d, nsup, ensup),),
                  (cv, d, nsup, ensup), cs.OPS["cg_assemble_slot"] * R * slots)
    if "node_assemble" in srcs:
        from quinoa_tpu_torch.ops.node_window import node_assemble_plain
        for name in cs.DIAGCG:
            calls = step_calls(solver(name), kernels, "node_assemble")
            if len(calls) != len(NODE_ASSEMBLE_CALLS):
                raise AssertionError(f"{name}: {len(calls)} K11 calls a "
                                     f"step, expected "
                                     f"{len(NODE_ASSEMBLE_CALLS)}")
            for label, (xa, xm, nsup) in zip(NODE_ASSEMBLE_CALLS, calls):
                rows = sum(t.shape[1] for t in (xa, xm) if t is not None)
                D, N = nsup.shape
                timed(f"K11 {name} {label} N={N} D={D} rows={rows}",
                      lambda: (kernels.node_assemble(xa, xm, nsup),),
                      lambda: (node_assemble_plain(xa, xm, nsup),),
                      tuple(t for t in (xa, xm, nsup) if t is not None),
                      cs.OPS["node_assemble_slot"] * D * N * rows)

    for path in paths:
        s = solver(path)
        for n in names + names[::-1] if len(names) > 1 else names * 2:
            use(n)
            print(f"[ab] {path} with {n}:", flush=True)
            state, _, wall = cs.drive(torch, s, path, card)
            digest = hashlib.sha1(state.u.cpu().numpy().tobytes())
            cs.phase(path, f"state after {cs.NSTEPS + 1} steps: sha1 "
                     f"{digest.hexdigest()[:16]}, t={float(state.t)!r}")
            if path in PROFILED:
                cs.profile_path(torch, s, path, state, wall / cs.NSTEPS)
            if path in ("mm_p1", "mm_thinc"):
                cs.mm_breakdown(torch, s, path, state)
    use("this")


if __name__ == "__main__":
    main()
