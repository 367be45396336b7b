"""Build and load the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

`csrc/rst.cu` is compiled for ``sm_90a`` at first use into
``build/kernels/`` at the root of the checkout, under a name that carries
a hash of the source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs when the module is
imported: the CPU tests import every module of the port, and the host
that runs them has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rst.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_int, _c_i64, _c_ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
# Every argument is typed: an untyped pointer would be cut to 32 bits.
_SIGNATURES = {
    # device, buf, dtype, tile_bytes, stride, wset, base, n, n_ctas,
    # threads, partial, out, stream
    "rst_read_launch": (_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_i64, _c_i64,
                        _c_i64, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr),
    # device, buf, dtype, tile_bytes, stride, wset, base, n, n_ctas,
    # threads, stream
    "rst_write_launch": (_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_i64, _c_i64,
                         _c_i64, _c_int, _c_int, _c_ptr),
}

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    the toolkit's default location."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librst_{digest[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the library now; returns its path and the compiler's
    output (``-Xptxas -v``: registers, shared memory and spills of each
    kernel).  Raises if nvcc fails."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if no build of the current
    source exists."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.rst_error_string.argtypes = [ctypes.c_int]
        lib.rst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if status != 0:
        text = library().rst_error_string(status).decode()
        raise RuntimeError(
            f"CUDA error: {text} (cudaError_t {status}) launching {kernel}")
