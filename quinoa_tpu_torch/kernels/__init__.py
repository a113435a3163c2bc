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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: flags of the one nvcc call.  No fast math: approximate division and
#: square root would move the Superbee and HLLC branches.  --fmad=false
#: keeps multiply-adds unfused, as torch's elementwise ops are, so each
#: kernel can be held tightly against its plain version.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

#: layout of the packed constant table (csrc/common.cuh TAB_*)
TAB_BSELF, TAB_BVOL, TAB_WDB, TAB_WFACE, TAB_SIZE = 0, 48, 68, 128, 131
#: DG(P1) compressible Euler: components, modes, face points
C, K, G = 5, 4, 3

#: kernel launches since the last reset_launches()
launches = {"limit_vol": 0, "face_flux": 0, "face_to_elem": 0}

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


def build() -> ctypes.CDLL:
    """Compile csrc/*.cu if needed and load the library (once per
    process).  The compiler's register/spill report is kept beside the
    library as <name>.log."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cus = [p for p in _sources() if p.endswith(".cu")]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus],
                              capture_output=True, text=True)
        with open(so[:-3] + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    P, D, L = ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"qtk_limit_vol_{sfx}")
        fn.argtypes = [P, P, P, P, P, D, D, D, P, P, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_face_flux_{sfx}")
        fn.argtypes = [P] * 10 + [D, D, P, P, P, L, L, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qtk_face_to_elem_{sfx}")
        fn.argtypes = [P] * 8 + [L, L, P]
        fn.restype = ctypes.c_int
    _lib = lib
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


def limit_vol(U, esuelT, jacInv, vole, ktab, beta, eos):
    """K1 (csrc/limit_vol.cu): (u_lim, rv), each (C*K, E)."""
    dev = _cuda_device(U)
    dt = U.dtype
    E = U.shape[1]
    _check("U", U, (C * K, E), dt, dev)
    _check("esuelT", esuelT, (4, E), torch.int32, dev)
    _check("jacInv", jacInv, (3, 3, E), dt, dev)
    _check("vole", vole, (E,), dt, dev)
    _check("ktab", ktab, (TAB_SIZE,), dt, dev)
    fn = getattr(build(), f"qtk_limit_vol_{_suffix(dt)}")
    ulim = torch.empty_like(U)
    rv = torch.empty_like(U)
    _launch("limit_vol", fn,
            [_ptr(U), _ptr(esuelT), _ptr(jacInv), _ptr(vole), _ptr(ktab),
             float(beta), float(eos.gamma), float(eos.pstiff), _ptr(ulim),
             _ptr(rv), E], dev)
    return ulim, rv


def face_flux(U, el, er, fn, farea, fmask, xi_l, xi_r, bctype, ktab, eos):
    """K2 (csrc/face_flux.cu): (contribL, contribR, mx): (C*K, F) x 2,
    (F,)."""
    dev = _cuda_device(U)
    dt = U.dtype
    E, F = U.shape[1], el.shape[0]
    _check("U", U, (C * K, E), dt, dev)
    for name, t in (("el", el), ("er", er), ("bctype", bctype)):
        _check(name, t, (F,), torch.int32, dev)
    _check("fn", fn, (3, F), dt, dev)
    _check("farea", farea, (F,), dt, dev)
    _check("fmask", fmask, (F,), dt, dev)
    _check("xi_l", xi_l, (3, G, F), dt, dev)
    _check("xi_r", xi_r, (3, G, F), dt, dev)
    _check("ktab", ktab, (TAB_SIZE,), dt, dev)
    lib_fn = getattr(build(), f"qtk_face_flux_{_suffix(dt)}")
    cL = torch.empty((C * K, F), dtype=dt, device=dev)
    cR = torch.empty((C * K, F), dtype=dt, device=dev)
    mx = torch.empty((F,), dtype=dt, device=dev)
    _launch("face_flux", lib_fn,
            [_ptr(U), _ptr(el), _ptr(er), _ptr(fn), _ptr(farea), _ptr(fmask),
             _ptr(xi_l), _ptr(xi_r), _ptr(bctype), _ptr(ktab),
             float(eos.gamma), float(eos.pstiff), _ptr(cL), _ptr(cR),
             _ptr(mx), E, F], dev)
    return cL, cR, mx


def face_to_elem(cL, cR, mx, fose, fsideR, rv=None):
    """K3 (csrc/face_to_elem.cu): (r (C*K, E), delt (E,)); r starts from
    rv when given, from zero otherwise."""
    dev = _cuda_device(cL)
    dt = cL.dtype
    F, E = cL.shape[1], fose.shape[1]
    _check("contribL", cL, (C * K, F), dt, dev)
    _check("contribR", cR, (C * K, F), dt, dev)
    _check("mx", mx, (F,), dt, dev)
    _check("fose", fose, (4, E), torch.int32, dev)
    _check("fsideR", fsideR, (4, E), dt, dev)
    if rv is not None:
        _check("rv", rv, (C * K, E), dt, dev)
    lib_fn = getattr(build(), f"qtk_face_to_elem_{_suffix(dt)}")
    r = torch.empty((C * K, E), dtype=dt, device=dev)
    delt = torch.empty((E,), dtype=dt, device=dev)
    _launch("face_to_elem", lib_fn,
            [_ptr(cL), _ptr(cR), _ptr(mx), _ptr(fose), _ptr(fsideR),
             ctypes.c_void_p(0 if rv is None else rv.data_ptr()), _ptr(r),
             _ptr(delt), E, F], dev)
    return r, delt
