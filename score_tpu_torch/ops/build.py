"""Build and load the band kernels (``csrc/band.cu``).

The CUDA source is compiled at first use with ``nvcc`` for sm_90a into a
shared library with a plain C interface, loaded with ctypes. The library
lands in ``score_tpu_torch/_build/`` (git-ignored) under a name carrying
the hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the existing file. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["band_library", "compile_band", "BUILD_DIR", "SOURCE"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "ops" / "csrc" / "band.cu"
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
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the band "
            "kernels cannot be built"
        )
    return found


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libscore_band-{h.hexdigest()[:16]}.so"


def compile_band(force: bool = False) -> tuple[Path, str]:
    """Compile the band kernels if the library for the current source is
    missing (or ``force``). Returns (library path, compiler output; the
    ptxas register/spill report when a build ran, else "")."""
    out = _target()
    if out.exists() and not force:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def band_library() -> ctypes.CDLL:
    """The loaded band kernel library (built on first call)."""
    path, _ = compile_band()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.band_error_string.argtypes = [i32]
    lib.band_error_string.restype = ctypes.c_char_p
    lib.band_init_a.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.band_init_a.restype = i32
    lib.band_block_inv.argtypes = [vp, vp, i64, i32, vp]
    lib.band_block_inv.restype = i32
    lib.band_pcr_level.argtypes = [vp] * 8 + [i32, i32, i32, i32, vp]
    lib.band_pcr_level.restype = i32
    lib.band_pcr_solve.argtypes = [vp] * 5 + [i32] * 6 + [vp]
    lib.band_pcr_solve.restype = i32
    lib.band_cr_level.argtypes = [vp] * 11 + [i32, i32, i32, vp]
    lib.band_cr_level.restype = i32
    lib.band_cr_reduce.argtypes = [vp] * 4 + [i32] * 4 + [vp]
    lib.band_cr_reduce.restype = i32
    lib.band_cr_backsub.argtypes = [vp] * 6 + [i32] * 4 + [vp]
    lib.band_cr_backsub.restype = i32
    return lib
