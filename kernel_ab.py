#!/usr/bin/env python3
"""A/B device times of the face pair K13 basis_accum and K14 mm_face_wflux
on one NVIDIA GPU:

    python3 kernel_ab.py [--paths] [--sass] NAME=DIR [NAME=DIR ...]

Each DIR holds a version of basis_accum.cu and mm_face_wflux.cu beside
the common.cuh they include (for example another commit's
quinoa_tpu_torch/csrc, unpacked with git archive into a directory that
.gitignore lists).  The files of a DIR that differ from this checkout's
are built with the package's nvcc flags into DIR/build/ (all at once, with
the ptxas report of registers and spills printed), and the version called
NAME takes those two kernels from them and everything else from this
checkout's library ("this").

At every instance of the two kernels on the port's paths (float32 at 48^3:
K14 at nmat 2/3, P0/P1, with and without THINC, K13 at its seven (R, K)
shapes; P2 at 32^3), on the states chip_smoke.py checks them on, each
version's kernel is held against the plain version bit for bit (NaN where
the plain version has NaN), then all versions are timed in turns with
chip_smoke.device_ms (device time of the kernel alone, each call from a
cold L2; median [min-max] of REPS), beside the bound (chip_smoke's rule).
With --paths, the p0, mm_p0, mm_p1, p1_lf, mm_thinc and p2 paths then run
1 + 10 steps with each version in turns (first to last, then back), with
their launch counts checked, and mm_p1 and mm_thinc print their stage
breakdown (chip_smoke.mm_breakdown) for each version.  With --sass, each
version's float32 K13/K14 instances first print their global loads and
the median distance from a load to its first use (cuobjdump).  Needs
nvcc."""

import argparse
import ctypes
import filecmp
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("basis_accum", "mm_face_wflux")


def build_versions(kernels, dirs):
    """{name: {source: .so path}} of the sources in each dir that differ
    from this checkout's, compiled at once; prints the ptxas report."""
    jobs = []
    for name, d in dirs.items():
        os.makedirs(os.path.join(d, "build"), exist_ok=True)
        for src in SOURCES:
            cu = os.path.join(d, f"{src}.cu")
            if filecmp.cmp(cu, os.path.join(kernels.CSRC, f"{src}.cu"),
                           shallow=False) and filecmp.cmp(
                    os.path.join(d, "common.cuh"),
                    os.path.join(kernels.CSRC, "common.cuh"), shallow=False):
                continue
            so = os.path.join(d, "build", f"lib{src}.so")
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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1].split("EEv")[0] + "EE"
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {entry}: {line.strip()}", flush=True)
        out[name][src] = so
    return out


class Library:
    """The checkout's kernel library with some entry points taken from
    other libraries (same C interface)."""

    def __init__(self, base, sos):
        self.base, self.fns = base, {}
        for src, so in sos.items():
            lib = ctypes.CDLL(so)
            for sfx in ("f32", "f64"):
                sym = f"qtk_{src}_{sfx}"
                fn = getattr(lib, sym)
                fn.argtypes = getattr(base, sym).argtypes
                fn.restype = ctypes.c_int
                self.fns[sym] = fn

    def __getattr__(self, sym):
        return self.fns[sym] if sym in self.fns else getattr(self.base, sym)


def load_to_use(kernels, so):
    """{kernel: (global loads, median instructions from a load to the
    first instruction that reads its register)} of the float32 K13/K14
    instances in the library so, from cuobjdump's SASS: how far ptxas
    hoists each load ahead of its use, i.e. how many loads a thread keeps
    in flight."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not re.search(r"(basis_accum|mm_face_wflux\w*)_kernelIf", name):
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
        out[name.split("EEv")[0] + "EE"] = (len(dist), dist[len(dist) // 2]
                                            if dist else None)
    return out


def same(got, want):
    """Bit for bit, a NaN matching a NaN."""
    return all(bool(((a == b) | (a.isnan() & b.isnan())).all())
               and a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(got, want))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    ap.add_argument("versions", nargs="+", help="NAME=DIR")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="print each version's load-to-use distances")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                                 face_wflux_plain,
                                                 mm_face_wflux_plain)
    from quinoa_tpu_torch.ops.nbr_bounds import limit_vol_plain
    from quinoa_tpu_torch.pde.dg import volume_rhs
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.problems import TaylorGreen

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = dict(v.split("=", 1) for v in args.versions)
    base = kernels.build()
    libs = {"this": base}
    sos = {"this": [kernels.library_path()]}
    for name, built in build_versions(kernels, dirs).items():
        libs[name] = Library(base, built)
        sos[name] = list(built.values())
    names = list(libs)
    if args.sass:
        for name in names:
            for so in sos[name]:
                for fn, (n, d) in load_to_use(kernels, so).items():
                    print(f"[sass] {name} {fn}: {n} global loads, median "
                          f"load-to-use {d} instructions", flush=True)

    def use(name):
        kernels._lib = libs[name]

    dev, f32 = torch.device("cuda", 0), torch.float32
    big = (cs.N_BIG,) * 3
    mmg = {n: cs.mm_geom(n, big, f32, dev) for n in ("p0", "mm_p1",
                                                      "mm_thinc")}
    mmg["mm_p0"], mmg["p1_lf"] = mmg["p0"], mmg["mm_p1"]
    solvers = {n: cs.mm_solver(n, mmg[n]) for n in cs.MM if n != "mm_iface"}
    p2g = cs.p2_geom((cs.N_P2,) * 3, f32, dev)
    taylor = DGCompFlow(TaylorGreen(), riemann_flux="hllc")
    solvers["p2"] = DGSolver(taylor, p2g, cfl=0.5, limiter=None)

    def timed(label, kf, pf, inputs, ops):
        want = pf()
        for n in names:
            use(n)
            if not same(kf(), want):
                raise AssertionError(f"{label}: {n}'s kernel differs from "
                                     "the plain version")
        got = kf()
        b = cs.nbytes(*inputs, *got)
        bound = max(1e3 * b / cs.HBM_BYTES_PER_S, 1e3 * ops / cs.F32_OPS_PER_S)
        times = cs.device_ms(torch, [lambda n=n: (use(n), kf())
                                     for n in names])
        use("this")
        cs.phase("ab", f"{label}: bit-identical to the plain version; " +
                 ", ".join(f"{n} {cs.spread(t)} ({100 * bound / t[0]:.1f}% "
                           "of bound)" for n, t in zip(names, times)) +
                 f"; bound {bound:.4f} ms ({b} bytes); "
                 f"{names[0]}/{names[-1]} {times[0][0] / times[-1][0]:.3f}")
        return want

    # K14 (and the K13 instances after it) on chip_smoke's multimat states
    thinc2 = cs.mm_solver("mm_thinc", mmg["mm_thinc"], nmat=2)
    cases = (("K14 (2, 1)", solvers["mm_p0"], False),
             ("K14 (3, 1)", cs.mm_solver("mm_p0", mmg["p0"], nmat=3), False),
             ("K14 (2, 4)", solvers["mm_p1"], False),
             ("K14 (3, 4)", solvers["mm_thinc"], False),
             ("K14-THINC (2, 4)", thinc2, True),
             ("K14-THINC (3, 4)", solvers["mm_thinc"], True))
    def k13(label, g, wfl, mx, R, K):
        xi = (g.xi_l, g.xi_r) if K > 1 else ()
        timed(f"K13 ({R}, {K}) E={g.nelem}{label}",
              lambda: kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l,
                                          g.xi_r, K),
              lambda: basis_accum_plain(g, wfl, mx),
              (wfl, mx, g.fose, g.fsideR, *xi),
              cs.OPS["basis_accum"][R, K] * g.nelem)

    flux = {}
    for label, solver, thinc in cases:
        sy, g = solver.system, solver.geom
        K, nmat, R = g.ndof, sy.nmat, sy.nrows
        U = cs.mm_perturbed(torch, solver)
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
            (U, g.el, g.er, g.fn, g.farea, g.fmask, *xi, g.bctype, g.w_face,
             *([X] if thinc else [])), cs.OPS[name][nmat, K] * g.nface)
        if label in ("K14 (2, 1)", "K14 (3, 1)", "K14 (2, 4)",
                     "K14-THINC (3, 4)"):
            k13("", g, wfl, mx, R, K)
            flux[R, K] = g, wfl, mx
    # (16, 4) and (22, 4) on each other's flux values and geometry: the
    # THINC flux's first 16 rows, and mm_p1's 16 rows with their first 6
    # again, to tell a gap between the two shapes from one in their data
    (g16, w16, m16), (g22, w22, m22) = flux[16, 4], flux[22, 4]
    k13(" on the THINC flux's first 16 rows", g22, w22[:48], m22, 16, 4)
    k13(" on mm_p1's flux rows 0-15, 0-5", g16,
        torch.cat([w16, w16[:18]]), m16, 22, 4)

    # K13 at five rows: p0 (K = 1), p1_lf (K = 4), p2 (K = 10)
    p0 = solvers["p0"]
    Up0 = torch.as_tensor(cs.perturbed_state(p0.geom.nelem, 23, K=1)).to(
        f32).to(dev)
    lf = solvers["p1_lf"]
    ulf, rvlf = limit_vol_plain(lf.system, lf.geom, cs.sod_perturbed(torch,
                                                                     lf))
    U2 = solvers["p2"].initial_state().u
    for solver, U, rv in ((p0, Up0, None), (lf, ulf, rvlf),
                          (solvers["p2"], U2, volume_rhs(taylor, p2g, U2))):
        g, K = solver.geom, solver.geom.ndof
        wfl, mx = face_wflux_plain(solver.system, g, U)
        xi = (g.xi_l, g.xi_r) if K > 1 else ()
        timed(f"K13 (5, {K}) E={g.nelem}",
              lambda: kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l,
                                          g.xi_r, K, rv),
              lambda: basis_accum_plain(g, wfl, mx, rv),
              tuple(t for t in (wfl, mx, g.fose, g.fsideR, *xi, rv)
                    if t is not None),
              cs.OPS["basis_accum"][5, K] * g.nelem)

    if args.paths:
        for path in ("p0", "mm_p0", "mm_p1", "p1_lf", "mm_thinc", "p2"):
            solver = solvers[path]
            for n in names + names[::-1]:
                use(n)
                print(f"[ab] {path} with {n}:", flush=True)
                state, _, _ = cs.drive(torch, solver, path, card)
                if path in ("mm_p1", "mm_thinc"):
                    cs.mm_breakdown(torch, solver, path, state)
        use("this")


if __name__ == "__main__":
    main()
