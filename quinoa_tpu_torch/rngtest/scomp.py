"""The scomp_ family's host code: LZ78 phrase counts and Berlekamp-Massey.

Both algorithms are sequential over the bit stream, so they run on the
host, in C++ (csrc/scomp.cpp, the port's own copy of the two functions
quinoa_tpu's native library holds).  The library is compiled with the
host C++ compiler at first use into ``quinoa_tpu_torch/build/`` and loaded
through ctypes; its file name carries a hash of the source and flags.  The
build writes a file of its own name and renames it into place, so
processes that build at once never load a half-written library.  A build
failure raises: the batteries have no quiet fallback.

Beside each function is its plain version (``lz78_phrases_plain``,
``berlekamp_massey_plain``), in Python and numpy, for small streams.

Bit streams are packed MSB-first in bytes (numpy.packbits' layout).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "scomp.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or $CXX): the scomp "
                       "tests need csrc/scomp.cpp built")


def library_path() -> str:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha1()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libquinoa_scomp_{h.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Compile csrc/scomp.cpp if needed and load it (once per process)."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {os.path.basename(SOURCE)} failed "
                               f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.qsc_lz78_phrases.restype = ctypes.c_int64
    lib.qsc_lz78_phrases.argtypes = [u8, ctypes.c_int64]
    lib.qsc_berlekamp_massey.restype = ctypes.c_int64
    lib.qsc_berlekamp_massey.argtypes = [
        u8, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def _packed(bits_packed, nbits):
    b = np.ascontiguousarray(bits_packed, dtype=np.uint8)
    if b.size * 8 < nbits:
        raise ValueError(f"{b.size} bytes hold fewer than {nbits} bits")
    return b


def lz78_phrases(bits_packed: np.ndarray, nbits: int) -> int:
    """The number of LZ78 phrases of the first nbits bits, a trailing
    incomplete phrase counted."""
    return int(build().qsc_lz78_phrases(_packed(bits_packed, nbits), nbits))


def berlekamp_massey(bits_packed: np.ndarray, nbits: int):
    """The linear complexity profile of the first nbits bits: (the size of
    each jump as int32, the final complexity L)."""
    b = _packed(bits_packed, nbits)
    cap = nbits // 2 + 2
    jumps = np.empty(cap, dtype=np.int32)
    fl = ctypes.c_int64(0)
    nj = int(build().qsc_berlekamp_massey(b, nbits, jumps, cap,
                                          ctypes.byref(fl)))
    return jumps[:nj].copy(), int(fl.value)


def lz78_phrases_plain(bits_packed: np.ndarray, nbits: int) -> int:
    """lz78_phrases in Python (quinoa_tpu's _lz78_phrases_py)."""
    bits = np.unpackbits(_packed(bits_packed, nbits))[:nbits]
    child: dict = {}
    cur, phrases, in_phrase = 0, 0, False
    nxt_id = 1
    for bit in bits:
        kk = (cur, int(bit))
        if kk in child:
            cur, in_phrase = child[kk], True
        else:
            child[kk] = nxt_id
            nxt_id += 1
            phrases += 1
            cur, in_phrase = 0, False
    return phrases + (1 if in_phrase else 0)


def berlekamp_massey_plain(bits_packed: np.ndarray, nbits: int):
    """berlekamp_massey on boolean numpy polynomials, O(nbits^2), with the
    library's word arithmetic: C and B span whole 64-bit words, the
    discrepancy sums the words of C that hold bits 0..L, B is the old C's
    words up to its L at a jump, and C ^= B << (t - m) runs over B's words
    without the carry of B's top word into the word above it, as
    quinoa_tpu's native qn_berlekamp_massey runs (its shift has that
    carry missing, so the profile can differ from the textbook one; see
    ROADMAP.md)."""
    s = np.unpackbits(_packed(bits_packed, nbits))[:nbits].astype(bool)
    nb = 64 * ((nbits + 64) // 64 + 2)          # the library's nw words
    C = np.zeros(nb, dtype=bool)
    B = np.zeros(nb, dtype=bool)
    C[0] = B[0] = True
    L, m, bwords, jumps = 0, -1, 1, []
    lane = np.arange(nb) % 64
    for t in range(nbits):
        # parity of sum_i c_i s_{t-i} over C's words up to bit L
        w = 64 * ((L >> 6) + 1)
        if not np.count_nonzero(C[:w][:t + 1] & s[t::-1][:w]) & 1:
            continue
        jump = 2 * L <= t
        T = C.copy()
        shift = t - m
        src = B[:64 * bwords].copy()
        # the top word's bits that cross into the next word are dropped
        src[64 * (bwords - 1):] &= lane[:64] + (shift & 63) < 64
        j = np.nonzero(src)[0] + shift
        C[j[j < nb]] ^= True
        if jump:
            jumps.append(t + 1 - 2 * L)
            cw = (L >> 6) + 1
            B = np.zeros(nb, dtype=bool)
            B[:64 * cw] = T[:64 * cw]
            bwords = cw
            L, m = t + 1 - L, t
    return np.asarray(jumps, dtype=np.int32), L
