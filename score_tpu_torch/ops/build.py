"""Build and load the port's CUDA kernel libraries (``csrc/*.cu``).

Each CUDA source is compiled at first use with ``nvcc`` for sm_90a into a
shared library with a plain C interface, loaded with ctypes:

    band    csrc/band.cu    the f64 band kernels  (ops/band.py)
    blocks  csrc/blocks.cu  the f32 block kernels (ops/blocks.py)

A library lands in ``score_tpu_torch/_build/`` (git-ignored) under a name
carrying the hash of its source and the flags, so an edited source
rebuilds and an unchanged one loads the existing file. :func:`compile_all`
starts one nvcc per source, all at once. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["band_library", "blocks_library", "compile_all", "BUILD_DIR", "SOURCES",
           "CR_MAX_LEVELS", "CrReduceLevels", "CrBacksubLevels",
           "CrReducePlan", "CrFactorLevels"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "band": _PKG / "ops" / "csrc" / "band.cu",
    "blocks": _PKG / "ops" / "csrc" / "blocks.cu",
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    # PyTorch's own toolkit lookup (CUDA_HOME, CUDA_PATH, nvcc on PATH,
    # the default install prefix)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libscore_{name}-{h.hexdigest()[:16]}.so"


def compile_all(names=None, force: bool = False) -> dict:
    """Compile the named libraries (default: all) whose file for the
    current source is missing (or all of them with ``force``), one nvcc
    process per source, started together. Returns {name: (library path,
    seconds, compiler output)}; the output holds the ptxas register/spill
    report when a build ran, else ""."""
    names = list(SOURCES) if names is None else list(names)
    out = {}
    jobs = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    for name in names:
        target = _target(name)
        if target.exists() and not force:
            out[name] = (target, 0.0, "")
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, target, tmp, proc, time.perf_counter()))
    failed = []
    for name, target, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: concurrent builders never see half a file
            out[name] = (target, seconds, log)
        else:
            failed.append(f"nvcc failed ({proc.returncode}) building {SOURCES[name]}:\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _load(name: str) -> ctypes.CDLL:
    path = compile_all([name])[name][0]
    lib = ctypes.CDLL(str(path))
    lib_error = getattr(lib, f"{name}_error_string")
    lib_error.argtypes = [ctypes.c_int]
    lib_error.restype = ctypes.c_char_p
    lib.error_string = lib_error  # cudaGetErrorString, for raise_on
    return lib


def raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on the error code ``err`` of ``lib``'s C entry point ``name``."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def launch(lib: ctypes.CDLL, name: str, t, *args) -> None:
    """Call ``lib``'s C entry point ``name`` with ``args`` and the current
    stream of the device of the tensor ``t``, with that device current (the
    entry point launches on, and sets kernel attributes of, the current
    device), and raise on its error code."""
    import torch

    with torch.cuda.device(t.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(t.device).cuda_stream)
    raise_on(lib, name, err)


# Levels a launch of band_cr_reduce / band_cr_backsub / band_cr_factor
# takes, and their pointers as the C entries take them, by value
# (csrc/band.cu: kCrMaxLevels, CrReduceLevels, CrBacksubLevels,
# CrFactorLevels).
CR_MAX_LEVELS = 10
_Pointers = ctypes.c_void_p * CR_MAX_LEVELS


class CrReduceLevels(ctypes.Structure):
    _fields_ = [("E", _Pointers), ("F", _Pointers), ("out", _Pointers)]


class CrBacksubLevels(ctypes.Structure):
    _fields_ = [("invD", _Pointers), ("A", _Pointers), ("C", _Pointers), ("b", _Pointers)]


# The tree reduce's plan (csrc/band.cu: CrReducePlan).
class CrReducePlan(ctypes.Structure):
    _fields_ = [("top", ctypes.c_int), ("P", ctypes.c_int), ("Kf", ctypes.c_int),
                ("Kc", ctypes.c_int), ("stage", ctypes.c_int)]


class CrFactorLevels(ctypes.Structure):
    _fields_ = [("E", _Pointers), ("F", _Pointers), ("invD", _Pointers), ("A", _Pointers),
                ("C", _Pointers)]


@functools.lru_cache(maxsize=None)
def band_library() -> ctypes.CDLL:
    """The loaded band kernel library (built on first call)."""
    return band_signatures(_load("band"))


def band_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/band.cu) with the argument and result types
    of its C entry points set: without them ctypes would pass the stream
    as a 32-bit int."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.band_init_a.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.band_init_a.restype = i32
    lib.band_block_inv.argtypes = [vp, vp, i64, i32, vp]
    lib.band_block_inv.restype = i32
    lib.band_pcr_level.argtypes = [vp] * 10 + [i32, i32, i32, i32, vp]
    lib.band_pcr_level.restype = i32
    lib.band_pcr_solve.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    lib.band_pcr_solve.restype = i32
    # D, A, C, 8 outputs, nC, Th, Db, P, stream
    lib.band_cr_level.argtypes = [vp] * 11 + [i32] * 4 + [vp]
    lib.band_cr_level.restype = i32
    # levels, b, n, nC, T, Db, K, P, Kc, stream
    lib.band_cr_reduce.argtypes = [CrReduceLevels, vp] + [i32] * 7 + [vp]
    lib.band_cr_reduce.restype = i32
    # levels, xe, x, n, nC, T, Db, K, P, Kc, stream
    lib.band_cr_backsub.argtypes = [CrBacksubLevels, vp, vp] + [i32] * 7 + [vp]
    lib.band_cr_backsub.restype = i32
    # levels, b, tickets, n, nC, Db, K, plan, stream
    lib.band_cr_reduce_chain.argtypes = [CrReduceLevels, vp, vp] + [i32] * 4 + [CrReducePlan, vp]
    lib.band_cr_reduce_chain.restype = i32
    # levels, xe, x, n, nC, Db, K, S, Kc, stream
    lib.band_cr_backsub_chain.argtypes = [CrBacksubLevels, vp, vp] + [i32] * 6 + [vp]
    lib.band_cr_backsub_chain.restype = i32
    # D, A, C, levels, D2, A2, C2, invD, n, nC, T, Db, P, stream
    lib.band_cr_factor.argtypes = [vp] * 3 + [CrFactorLevels] + [vp] * 4 + [i32] * 5 + [vp]
    lib.band_cr_factor.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def blocks_library() -> ctypes.CDLL:
    """The loaded block kernel library (built on first call)."""
    lib = _load("blocks")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # A, L, M, D, A's block stride, stream
    lib.block_chol.argtypes = [vp, vp, i64, i32, i64, vp]
    lib.block_chol.restype = i32
    for solve in (lib.block_tri_lower_solve, lib.block_chol_solve):
        # L, B, out, M, D, K, B's three element strides, then B2, out2
        # (null for one rhs) and B2's strides, stream
        solve.argtypes = [vp, vp, vp, i64, i32, i32, i64, i64, i64,
                          vp, vp, i64, i64, i64, vp]
        solve.restype = i32
    return lib
