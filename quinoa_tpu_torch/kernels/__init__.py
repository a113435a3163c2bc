"""Build, load and launch the hand-written CUDA kernels of csrc/.

The kernels are compiled with nvcc for sm_90a (Hopper) at first use, into
``quinoa_tpu_torch/build/`` (listed in .gitignore), as one shared library
with a plain C interface loaded through ctypes.  The library's file name
carries a hash of the sources, so an edited source is never served by a
stale binary.  Nothing is built or imported when this module is imported:
the CPU test tier imports every module and has no nvcc.

Each launch function takes CUDA tensors only, checks device, dtype, shape
and contiguity, allocates its outputs with torch.empty, launches on the
current stream, raises if the launch reports a CUDA error, and then adds
one to its entry of ``launches``.  The dispatch between a kernel and its
plain torch version lives in the ops modules: a CPU tensor takes the plain
version, a CUDA tensor the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from ..base.profiler import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: flags of the one nvcc call.  No fast math: approximate division and
#: square root would move the Superbee and HLLC branches.  --fmad=false
#: keeps multiply-adds unfused, as torch's elementwise ops are, so each
#: kernel can be held tightly against its plain version.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

#: layout of the packed constant table (csrc/common.cuh TAB_*)
TAB_BSELF, TAB_BVOL, TAB_WDB, TAB_WFACE, TAB_SIZE = 0, 48, 68, 128, 131
#: DG(P1) compressible Euler, the shapes of K1: components, modes, face
#: points.  K4-K6, the transport flavours of K7-K8, K9 and K11 take their
#: row counts as arguments.
C, K, G = 5, 4, 3
#: the (mode, direction) entries of w_vol*dBdxi_vol that are not zero for
#: the P1 Dubiner basis (dB0 = 0, dB2/dxi = 0, dB3/dxi = dB3/deta = 0);
#: K1 and K16 add only these (csrc/common.cuh wdb_nonzero)
WDB_NONZERO = np.array([[False, False, False], [True, True, True],
                        [False, True, True], [False, False, True]])
#: the face kernels K12-K14 take DG(P0), DG(P1) and DG(P2): face points
#: per number of modes (ops/quadrature.py ng_face)
FACE_POINTS = {1: 1, 4: 3, 10: 6}
#: (rows, modes) instances of K13: compressible Euler (5 rows) at P0-P2,
#: multimat (R = 3*nmat + 3 + 3*nmat + 1: 16 or 22 rows) at P0 and P1
BASIS_ACCUM_SHAPES = {(5, 1), (5, 4), (5, 10), (16, 1), (16, 4), (22, 1),
                      (22, 4)}
#: materials of the multimat kernels K14-K16
MM_NMAT = (2, 3)
#: THINC carrier rows a material of K14's THINC flavour reads (pde/multimat.py
#: thinc_carriers): the 4 P1 modes of q, then q0, the flag, rho_k, rhoE_k
THINC_ROWS = 8
#: the Riemann fluxes of K12 (csrc/common.cuh FLUX_*) and the launch counter
#: of each flavour
FLUXES = {"hllc": (0, "face_wflux"), "laxfriedrichs": (1, "face_wflux_lf")}

#: kernel launches since the last reset_launches()
launches = {"limit_vol": 0, "limit_vol_pref": 0, "nbr_bounds": 0,
            "face_gather": 0, "face_accum": 0, "alecg_vol": 0,
            "alecg_vol_cf": 0, "alecg_edge": 0, "alecg_edge_cf": 0,
            "cg_assemble": 0, "node_gather": 0, "node_assemble": 0,
            "face_wflux": 0, "face_wflux_lf": 0, "basis_accum": 0,
            "mm_face_wflux": 0, "mm_face_wflux_thinc": 0, "mm_limit": 0,
            "mm_volume": 0, "mm_volume_nc": 0}

_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def pack_tables(tables: dict, dtype: torch.dtype, device) -> torch.Tensor:
    """The constants the kernels read, flat: B_selfface (4,G,K), B_vol
    (Gv,K), w_vol*dBdxi_vol (Gv,K,3), w_face (G,)."""
    bself = np.asarray(tables["B_selfface"])
    bvol = np.asarray(tables["B_vol"])
    wdb = np.asarray(tables["w_vol"])[:, None, None] * np.asarray(
        tables["dBdxi_vol"])
    wface = np.asarray(tables["w_face"])
    if bself.shape != (4, G, K) or bvol.shape != (5, K) or wface.shape != (G,):
        raise NotImplementedError("the kernels implement DG(P1) tables only")
    if not np.array_equal(wdb != 0, np.broadcast_to(WDB_NONZERO, wdb.shape)):
        raise ValueError("K1 adds w_vol*dBdxi_vol only where the P1 Dubiner "
                         "basis has it nonzero (WDB_NONZERO); this table "
                         "has other zeros")
    flat = np.concatenate([bself.ravel(), bvol.ravel(), wdb.ravel(), wface])
    assert flat.size == TAB_SIZE
    return torch.as_tensor(flat).to(dtype).to(device)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha1()
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = f"libquinoa_kernels_{h.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def _compile(so: str):
    """One nvcc per source, all started together, then one link; the
    compiler's reports go to <library>.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{so[:-3]}.{os.getpid()}"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(p)[:-3]}.o" for p in cus]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(cus, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        with open(so[:-3] + ".log", "w") as fh:
            fh.write("".join(logs))
        for src, proc, log in zip(cus, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({proc.returncode}):\n{log[-4000:]}")
        tmp = f"{tag}.tmp"
        proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def build() -> ctypes.CDLL:
    """Compile csrc/*.cu if needed and load the library (once per
    process).  The compiler's register/spill report is kept beside the
    library as <name>.log.  Spans (base/profiler.py): kernels.build (nvcc,
    which also counts one kernels_built) and kernels.load."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        with span("kernels.build"):
            _compile(so)
        count("kernels_built")
    with span("kernels.load"):
        _lib = _load(so)
    return _lib


def _load(so: str) -> ctypes.CDLL:
    """The library at so, with the argument types of its entries."""
    lib = ctypes.CDLL(so)
    P, D, L = ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong
    I = ctypes.c_int
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"qtk_limit_vol_{sfx}")
        fn.argtypes = [P, P, P, P, P, D, D, D, P, P, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_limit_vol_pref_{sfx}")
        fn.argtypes = [P, P, P, P, P, P, D, D, D, P, P, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_nbr_bounds_{sfx}")
        fn.argtypes = [P] * 4 + [I, I, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_face_gather_{sfx}")
        fn.argtypes = [P] * 3 + [I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_face_accum_{sfx}")
        fn.argtypes = [P] * 6 + [I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_alecg_vol_node_{sfx}")
        fn.argtypes = [P] * 6 + [I, L, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_alecg_vol_cf_{sfx}")
        fn.argtypes = [P] * 4 + [D, D, P, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_alecg_edge_{sfx}")
        fn.argtypes = [P] * 4 + [I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_alecg_edge_cf_{sfx}")
        fn.argtypes = [P] * 3 + [D, D, P, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_cg_assemble_{sfx}")
        fn.argtypes = [P] * 5 + [I, I, I, L, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_node_gather_{sfx}")
        fn.argtypes = [P] * 3 + [I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_node_assemble_{sfx}")
        fn.argtypes = [P] * 4 + [I, I, I, I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_face_wflux_{sfx}")
        fn.argtypes = [P] * 10 + [D, D, P, P, I, I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_basis_accum_{sfx}")
        fn.argtypes = [P] * 9 + [I, I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_mm_face_wflux_{sfx}")
        fn.argtypes = [P] * 10 + [D] * 6 + [P, D, P, P, I, I, I, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_mm_limit_{sfx}")
        fn.argtypes = [P, P, P, D, P, I, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_mm_volume_{sfx}")
        fn.argtypes = [P] * 6 + [D] * 6 + [P, P, I, L, P]
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's ptxas report (registers, spills) of the loaded library."""
    with open(library_path()[:-3] + ".log") as fh:
        return fh.read()


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the kernels take float32 or float64, not {dtype}")


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got {t.device}")
    return t.device


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(name, fn, args, device):
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    launches[name] += 1


def limit_vol(U, esuelT, jacInv, vole, ktab, beta, eos, ndofel=None):
    """K1 (csrc/limit_vol.cu): (u_lim, rv), each (C*K, E).  With ndofel
    (E,) int32, the p-adaptive flavour, counted as limit_vol_pref: a P0
    element's u_lim is its masked state and its rv rows are zero."""
    dev = _cuda_device(U)
    dt = U.dtype
    E = U.shape[1]
    _check("U", U, (C * K, E), dt, dev)
    _check("esuelT", esuelT, (4, E), torch.int32, dev)
    _check("jacInv", jacInv, (3, 3, E), dt, dev)
    _check("vole", vole, (E,), dt, dev)
    _check("ktab", ktab, (TAB_SIZE,), dt, dev)
    name, nd = "limit_vol", []
    if ndofel is not None:
        _check("ndofel", ndofel, (E,), torch.int32, dev)
        name, nd = "limit_vol_pref", [_ptr(ndofel)]
    fn = getattr(build(), f"qtk_{name}_{_suffix(dt)}")
    ulim = torch.empty_like(U)
    rv = torch.empty_like(U)
    _launch(name, fn,
            [_ptr(U), _ptr(esuelT), *nd, _ptr(jacInv), _ptr(vole),
             _ptr(ktab), float(beta), float(eos.gamma), float(eos.pstiff),
             _ptr(ulim), _ptr(rv), E], dev)
    return ulim, rv


def nbr_bounds(U, esuelT, ncomp, ndof):
    """K4 (csrc/nbr_bounds.cu): (umin, umax), each (ncomp, E), over the
    cell means U[c*ndof] of the element and its face neighbours."""
    dev = _cuda_device(U)
    dt = U.dtype
    E = U.shape[1]
    _check("U", U, (ncomp * ndof, E), dt, dev)
    _check("esuelT", esuelT, (4, E), torch.int32, dev)
    fn = getattr(build(), f"qtk_nbr_bounds_{_suffix(dt)}")
    umin = torch.empty((ncomp, E), dtype=dt, device=dev)
    umax = torch.empty((ncomp, E), dtype=dt, device=dev)
    _launch("nbr_bounds", fn,
            [_ptr(U), _ptr(esuelT), _ptr(umin), _ptr(umax), int(ncomp),
             int(ndof), E], dev)
    return umin, umax


def mm_limit(U, esuelT, ktab, nmat):
    """K15 (csrc/mm_limit.cu): the consistent-Superbee-limited copy (C*K,
    E) of the multimat DG(P1) state U, C = 3*nmat + 3 with nmat in
    MM_NMAT, K = 4: the neighbour-mean bounds, the Superbee phi of every
    component (beta 2, pde/limiter.py superbee_phi's default, as the
    multimat solvers limit), the common fraction factor
    (consistent_mm_phi), mode 0 copied and modes 1-3 scaled."""
    if nmat not in MM_NMAT:
        raise ValueError(f"the multimat limit kernel takes nmat in "
                         f"{MM_NMAT}, not {nmat}")
    E = U.shape[-1]
    _check("U", U, ((3 * nmat + 3) * K, E), U.dtype, U.device)
    dev = _cuda_device(U)
    dt = U.dtype
    _check("esuelT", esuelT, (4, E), torch.int32, dev)
    _check("ktab", ktab, (TAB_SIZE,), dt, dev)
    fn = getattr(build(), f"qtk_mm_limit_{_suffix(dt)}")
    out = torch.empty_like(U)
    _launch("mm_limit", fn,
            [_ptr(U), _ptr(esuelT), _ptr(ktab), 2.0, _ptr(out), int(nmat),
             E], dev)
    return out


def mm_volume(U, jacInv, vol, emask, ktab, wB, eos, acc=None):
    """K16 (csrc/mm_volume.cu): the volume Gauss-point pass of the multimat
    DG(P1) state U (C*K, E), C = 3*nmat + 3 with nmat = len(eos) in
    MM_NMAT, K = 4, with the P1 tables ktab and the volume points' w*B
    (DGGeom.wB_vol).  Without acc, the flux volume integral (C*K, E)
    scaled by vol*emask, counted as mm_volume.  With acc, the face pass's
    sums (R*K, E), R = C + 3*nmat + 1, the stage's rhs (C*K, E): ((acc's
    C*K rows + the volume integral) + the non-conservative integral) *
    emask, counted as mm_volume_nc."""
    nmat = len(eos)
    if nmat not in MM_NMAT:
        raise ValueError(f"the multimat volume kernel takes nmat in "
                         f"{MM_NMAT}, not {nmat}")
    nc = 3 * nmat + 3
    E, dt, dev = U.shape[-1], U.dtype, U.device
    _check("U", U, (nc * K, E), dt, dev)
    if acc is not None:
        _check("acc", acc, ((nc + 3 * nmat + 1) * K, E), dt, dev)
    _check("jacInv", jacInv, (3, 3, E), dt, dev)
    _check("vol", vol, (E,), dt, dev)
    _check("emask", emask, (E,), dt, dev)
    _check("ktab", ktab, (TAB_SIZE,), dt, dev)
    _check("wB", wB, (5, K), dt, dev)
    _cuda_device(U)
    gam = [float(e.gamma) for e in eos] + [0.0] * (3 - nmat)
    pst = [float(e.pstiff) for e in eos] + [0.0] * (3 - nmat)
    fn = getattr(build(), f"qtk_mm_volume_{_suffix(dt)}")
    out = torch.empty_like(U)
    _launch("mm_volume" if acc is None else "mm_volume_nc", fn,
            [_ptr(U), _ptr(jacInv), _ptr(vol), _ptr(emask), _ptr(ktab),
             _ptr(wB), *gam, *pst,
             ctypes.c_void_p(0 if acc is None else acc.data_ptr()), _ptr(out),
             nmat, E], dev)
    return out


def face_gather(U, idx):
    """K5 (csrc/face_gather.cu): U[:, idx], (R, F) from U (R, E) and the
    int32 element index idx (F,)."""
    dev = _cuda_device(U)
    dt = U.dtype
    R, E = U.shape
    F = idx.shape[0]
    _check("U", U, (R, E), dt, dev)
    _check("idx", idx, (F,), torch.int32, dev)
    fn = getattr(build(), f"qtk_face_gather_{_suffix(dt)}")
    out = torch.empty((R, F), dtype=dt, device=dev)
    _launch("face_gather", fn, [_ptr(U), _ptr(idx), _ptr(out), R, E, F], dev)
    return out


def face_accum(cL, cR, fose, fsideR, base=None):
    """K6 (csrc/face_accum.cu): (R, E) sums of each element's four face
    rows of cL/cR (R, F), picked by fsideR, on top of base (R, E) when
    given, of zero otherwise."""
    dev = _cuda_device(cL)
    dt = cL.dtype
    R, F = cL.shape
    E = fose.shape[1]
    _check("contribL", cL, (R, F), dt, dev)
    _check("contribR", cR, (R, F), dt, dev)
    _check("fose", fose, (4, E), torch.int32, dev)
    _check("fsideR", fsideR, (4, E), dt, dev)
    if base is not None:
        _check("base", base, (R, E), dt, dev)
    fn = getattr(build(), f"qtk_face_accum_{_suffix(dt)}")
    r = torch.empty((R, E), dtype=dt, device=dev)
    _launch("face_accum", fn,
            [_ptr(cL), _ptr(cR), _ptr(fose), _ptr(fsideR),
             ctypes.c_void_p(0 if base is None else base.data_ptr()), _ptr(r),
             R, E, F], dev)
    return r


def alecg_vol(u, inpoelT, grad, w, vel):
    """K7 transport (csrc/alecg_vol.cu): cv (R, E), the element term
    -w * sum_b sum_j grad_bj * (vel_j(n_b) * u_b) of the R rows of u (R,
    N), with the static node velocities vel (Cv, 3, N): Cv = 1 when every
    row has the same velocity, else R."""
    dev = _cuda_device(u)
    dt = u.dtype
    R, N = u.shape
    E = inpoelT.shape[1]
    Cv = vel.shape[0]
    if Cv not in (1, R):
        raise ValueError(f"vel has {Cv} rows, expected 1 or {R}")
    _check("u", u, (R, N), dt, dev)
    _check("inpoelT", inpoelT, (4, E), torch.int32, dev)
    _check("grad", grad, (4, 3, E), dt, dev)
    _check("w", w, (E,), dt, dev)
    _check("vel", vel, (Cv, 3, N), dt, dev)
    fn = getattr(build(), f"qtk_alecg_vol_node_{_suffix(dt)}")
    cv = torch.empty((R, E), dtype=dt, device=dev)
    _launch("alecg_vol", fn,
            [_ptr(u), _ptr(inpoelT), _ptr(grad), _ptr(w), _ptr(vel),
             _ptr(cv), R, 0 if Cv == 1 else 3 * N, N, E], dev)
    return cv


def alecg_vol_cf(u, inpoelT, grad, w, eos):
    """K7 compflow (csrc/alecg_vol.cu): cv (5, E), the element term with
    the Euler flux of each corner's conservative state u (5, N)."""
    dev = _cuda_device(u)
    dt = u.dtype
    N = u.shape[1]
    E = inpoelT.shape[1]
    _check("u", u, (C, N), dt, dev)
    _check("inpoelT", inpoelT, (4, E), torch.int32, dev)
    _check("grad", grad, (4, 3, E), dt, dev)
    _check("w", w, (E,), dt, dev)
    fn = getattr(build(), f"qtk_alecg_vol_cf_{_suffix(dt)}")
    cv = torch.empty((C, E), dtype=dt, device=dev)
    _launch("alecg_vol_cf", fn,
            [_ptr(u), _ptr(inpoelT), _ptr(grad), _ptr(w), float(eos.gamma),
             float(eos.pstiff), _ptr(cv), N, E], dev)
    return cv


def alecg_edge(u, edges, w):
    """K8 transport (csrc/alecg_edge.cu): d (R, nE) = w * (u_b - u_a) over
    the edges (2, nE) with the static weight w = A*lambda (nE,)."""
    dev = _cuda_device(u)
    dt = u.dtype
    R, N = u.shape
    nE = edges.shape[1]
    _check("u", u, (R, N), dt, dev)
    _check("edges", edges, (2, nE), torch.int32, dev)
    _check("w", w, (nE,), dt, dev)
    fn = getattr(build(), f"qtk_alecg_edge_{_suffix(dt)}")
    d = torch.empty((R, nE), dtype=dt, device=dev)
    _launch("alecg_edge", fn,
            [_ptr(u), _ptr(edges), _ptr(w), _ptr(d), R, N, nE], dev)
    return d


def alecg_edge_cf(u, edges, A, eos):
    """K8 compflow (csrc/alecg_edge.cu): d (5, nE) = A * max(cs_a, cs_b)
    * (u_b - u_a), cs = |v| + sound speed with p clamped to >= 0."""
    dev = _cuda_device(u)
    dt = u.dtype
    N = u.shape[1]
    nE = edges.shape[1]
    _check("u", u, (C, N), dt, dev)
    _check("edges", edges, (2, nE), torch.int32, dev)
    _check("A", A, (nE,), dt, dev)
    fn = getattr(build(), f"qtk_alecg_edge_cf_{_suffix(dt)}")
    d = torch.empty((C, nE), dtype=dt, device=dev)
    _launch("alecg_edge_cf", fn,
            [_ptr(u), _ptr(edges), _ptr(A), float(eos.gamma),
             float(eos.pstiff), _ptr(d), N, nE], dev)
    return d


def cg_assemble(cv, d, nsup, ensup):
    """K9 (csrc/cg_assemble.cu): r (R, N), each node's element slots of
    cv (R, E) through nsup (Dv, N) plus its edge slots of +-d (R, nE)
    through ensup (Dd, N), each summed level by level from level 0."""
    dev = _cuda_device(cv)
    dt = cv.dtype
    R, E = cv.shape
    nE = d.shape[1]
    Dv, N = nsup.shape
    Dd = ensup.shape[0]
    if R < 1:
        raise ValueError("cg_assemble needs at least one row")
    if Dv < 1 or Dd < 1:
        raise ValueError("cg_assemble needs at least one slot level")
    _check("cv", cv, (R, E), dt, dev)
    _check("d", d, (R, nE), dt, dev)
    _check("nsup", nsup, (Dv, N), torch.int32, dev)
    _check("ensup", ensup, (Dd, N), torch.int32, dev)
    fn = getattr(build(), f"qtk_cg_assemble_{_suffix(dt)}")
    r = torch.empty((R, N), dtype=dt, device=dev)
    _launch("cg_assemble", fn,
            [_ptr(cv), _ptr(d), _ptr(nsup), _ptr(ensup), _ptr(r), R, Dv, Dd,
             N, E, nE], dev)
    return r


def node_gather(U, inpoelT):
    """K10 (csrc/node_gather.cu): (4, R, E) element-corner slabs
    out[a, c, e] = U[c, inpoelT[a, e]] of the R rows of U (R, N)."""
    dev = _cuda_device(U)
    dt = U.dtype
    R, N = U.shape
    E = inpoelT.shape[1]
    if R < 1:
        raise ValueError("node_gather needs at least one row")
    _check("U", U, (R, N), dt, dev)
    _check("inpoelT", inpoelT, (4, E), torch.int32, dev)
    fn = getattr(build(), f"qtk_node_gather_{_suffix(dt)}")
    out = torch.empty((4, R, E), dtype=dt, device=dev)
    _launch("node_gather", fn, [_ptr(U), _ptr(inpoelT), _ptr(out), R, N, E],
            dev)
    return out


def node_assemble(xa, xm, nsup):
    """K11 (csrc/node_assemble.cu): (Ra + Rm, N), the sums of xa (4, Ra, E)
    over each node's slots of nsup (D, N), level by level from level 0,
    then the maxima of xm (Am, Rm, E), Am = 4 corners or 1 row shared by
    an element's corners; either slab may be None."""
    ref = xa if xa is not None else xm
    if ref is None:
        raise ValueError("node_assemble needs a sum or a max slab")
    dev = _cuda_device(ref)
    dt = ref.dtype
    E = ref.shape[2]
    D, N = nsup.shape
    if D < 1:
        raise ValueError("node_assemble needs at least one slot level")
    Ra = 0 if xa is None else xa.shape[1]
    Rm, Am = (0, 4) if xm is None else (xm.shape[1], xm.shape[0])
    if xa is not None:
        _check("xa", xa, (4, Ra, E), dt, dev)
    if xm is not None:
        if Am not in (1, 4):
            raise ValueError(f"xm has {Am} corners, expected 1 or 4")
        _check("xm", xm, (Am, Rm, E), dt, dev)
    _check("nsup", nsup, (D, N), torch.int32, dev)
    fn = getattr(build(), f"qtk_node_assemble_{_suffix(dt)}")
    out = torch.empty((Ra + Rm, N), dtype=dt, device=dev)
    null = ctypes.c_void_p(0)
    _launch("node_assemble", fn,
            [null if xa is None else _ptr(xa),
             null if xm is None else _ptr(xm), _ptr(nsup), _ptr(out), Ra, Rm,
             Am, D, N, E], dev)
    return out


def _face_ndof(ndof, allowed=tuple(FACE_POINTS)):
    if ndof not in allowed:
        raise ValueError(f"the face kernel takes ndof in {tuple(allowed)}, "
                         f"not {ndof}")
    return ndof, FACE_POINTS[ndof]


def _check_faces(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype, w_face,
                 rows, ndof, ng):
    """The face kernels' common inputs: U (rows*ndof, E) and the face
    tables of F faces at ng points."""
    dev, dt = U.device, U.dtype
    E, F = U.shape[1], el.shape[0]
    _check("U", U, (rows * ndof, E), dt, dev)
    for name, t in (("el", el), ("er", er), ("bctype", bctype)):
        _check(name, t, (F,), torch.int32, dev)
    _check("fn", fn, (3, F), dt, dev)
    _check("farea", farea, (F,), dt, dev)
    _check("fmask", fmask, (F,), dt, dev)
    _check("xi_l", xi_l, (3, ng, F), dt, dev)
    _check("xi_r", xi_r, (3, ng, F), dt, dev)
    _check("w_face", w_face, (ng,), dt, dev)
    return E, F


def face_wflux(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype, w_face,
               eos, flux="hllc"):
    """K12 (csrc/face_wflux.cu): (wfl (C*G, F), mx (F,)), the weighted
    Riemann flux (HLLC, or "laxfriedrichs") at the G face points (row c*G
    + g) and the weighted charvel, of the Euler state U (C*K, E), K = 1
    (G = 1), 4 (G = 3) or 10 (G = 6).  A launch counts under FLUXES[flux]'s
    counter: face_wflux for HLLC, face_wflux_lf for Lax-Friedrichs."""
    dev = _cuda_device(U)
    dt = U.dtype
    if flux not in FLUXES:
        raise ValueError(f"the face kernel takes the fluxes {tuple(FLUXES)}, "
                         f"not {flux!r}")
    code, counter = FLUXES[flux]
    ndof, ng = _face_ndof(U.shape[0] // C)
    E, F = _check_faces(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype,
                        w_face, C, ndof, ng)
    lib_fn = getattr(build(), f"qtk_face_wflux_{_suffix(dt)}")
    wfl = torch.empty((C * ng, F), dtype=dt, device=dev)
    mx = torch.empty((F,), dtype=dt, device=dev)
    _launch(counter, lib_fn,
            [_ptr(U), _ptr(el), _ptr(er), _ptr(fn), _ptr(farea), _ptr(fmask),
             _ptr(xi_l), _ptr(xi_r), _ptr(bctype), _ptr(w_face),
             float(eos.gamma), float(eos.pstiff), _ptr(wfl), _ptr(mx), ndof,
             code, E, F], dev)
    return wfl, mx


def mm_face_wflux(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype, w_face,
                  eos, carriers=None, beta=0.0):
    """K14 (csrc/mm_face_wflux.cu): (wfl (R*G, F), mx (F,)) of the
    multimat state U (C*K, E), C = 3*nmat + 3 with nmat = len(eos) in
    MM_NMAT, K = 1 (G = 1) or 4 (G = 3): at each face point the weighted
    AUSM+up flux (C rows), -ap_k*n_i (3*nmat rows) and -vriem (1 row), R =
    C + 3*nmat + 1, row r*G + g; mx the weighted multimat charvel.

    With carriers (THINC_ROWS*nmat, E) (pde/multimat.py thinc_carriers, K
    = 4 only) the THINC flavour: both sides' face states are sharpened
    with the tanh profile of steepness beta before AUSM+up (the charvel
    keeps the raw states); it counts under mm_face_wflux_thinc."""
    dev = _cuda_device(U)
    dt = U.dtype
    nmat = len(eos)
    if nmat not in MM_NMAT:
        raise ValueError(f"the multimat face kernel takes nmat in "
                         f"{MM_NMAT}, not {nmat}")
    nc = 3 * nmat + 3
    R = nc + 3 * nmat + 1
    thinc = carriers is not None
    ndof, ng = _face_ndof(U.shape[0] // nc, (4,) if thinc else (1, 4))
    E, F = _check_faces(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype,
                        w_face, nc, ndof, ng)
    if thinc:
        _check("carriers", carriers, (THINC_ROWS * nmat, E), dt, dev)
    gam = [float(e.gamma) for e in eos] + [0.0] * (3 - nmat)
    pst = [float(e.pstiff) for e in eos] + [0.0] * (3 - nmat)
    lib_fn = getattr(build(), f"qtk_mm_face_wflux_{_suffix(dt)}")
    wfl = torch.empty((R * ng, F), dtype=dt, device=dev)
    mx = torch.empty((F,), dtype=dt, device=dev)
    _launch("mm_face_wflux_thinc" if thinc else "mm_face_wflux", lib_fn,
            [_ptr(U), _ptr(el), _ptr(er), _ptr(fn), _ptr(farea), _ptr(fmask),
             _ptr(xi_l), _ptr(xi_r), _ptr(bctype), _ptr(w_face), *gam, *pst,
             ctypes.c_void_p(carriers.data_ptr() if thinc else 0),
             float(beta), _ptr(wfl), _ptr(mx), nmat, ndof, int(thinc), E, F],
            dev)
    return wfl, mx


def basis_accum(wfl, mx, fose, fsideR, xi_l, xi_r, ndof, rv=None):
    """K13 (csrc/basis_accum.cu): (r (R*K, E), delt (E,)): each element's
    four faces' weighted flux wfl (R*G, F) contracted with its own side's
    basis and summed in slot order (minus on left faces), on top of rv
    when given, of zero otherwise; delt sums the faces' mx (F,).  (R, K)
    in BASIS_ACCUM_SHAPES."""
    dev = _cuda_device(wfl)
    dt = wfl.dtype
    ndof, ng = _face_ndof(ndof)
    F, E = wfl.shape[1], fose.shape[1]
    R = wfl.shape[0] // ng
    if (R, ndof) not in BASIS_ACCUM_SHAPES:
        raise ValueError(f"basis_accum has no instance for {R} rows at "
                         f"ndof {ndof}")
    _check("wfl", wfl, (R * ng, F), dt, dev)
    _check("mx", mx, (F,), dt, dev)
    _check("fose", fose, (4, E), torch.int32, dev)
    _check("fsideR", fsideR, (4, E), dt, dev)
    _check("xi_l", xi_l, (3, ng, F), dt, dev)
    _check("xi_r", xi_r, (3, ng, F), dt, dev)
    if rv is not None:
        _check("rv", rv, (R * ndof, E), dt, dev)
    lib_fn = getattr(build(), f"qtk_basis_accum_{_suffix(dt)}")
    r = torch.empty((R * ndof, E), dtype=dt, device=dev)
    delt = torch.empty((E,), dtype=dt, device=dev)
    _launch("basis_accum", lib_fn,
            [_ptr(wfl), _ptr(mx), _ptr(fose), _ptr(fsideR), _ptr(xi_l),
             _ptr(xi_r), ctypes.c_void_p(0 if rv is None else rv.data_ptr()),
             _ptr(r), _ptr(delt), R, ndof, E, F], dev)
    return r, delt
