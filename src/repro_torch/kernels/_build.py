"""Build and load the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

Every ``csrc/*.cu`` is compiled for ``sm_90a`` at first use, one nvcc
process per source, all started together, and the objects are linked
into one library in ``build/kernels/`` at the root of the checkout.  Its
name carries a hash of every source and header under ``csrc/`` and of the
flags, so an edited source is rebuilt and an unchanged one is loaded as
it is.  Nothing here runs when the module is
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
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # device, buf, dtype, tile_bytes, stride, wset, base, n, engines,
    # burst_beats, steps, n_ctas, threads, partial, out, stream
    "rst_contend_read_launch": (_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_i64,
                                _c_i64, _c_i64, _c_i64, _c_i64, _c_i64, _c_int,
                                _c_int, _c_ptr, _c_ptr, _c_ptr),
    # device, buf, dtype, tile_bytes, table, engines, steps, n_ctas,
    # threads, partial, out, stream
    "rst_contend_mix_read_launch": (_c_int, _c_ptr, _c_int, _c_i64, _c_ptr,
                                    _c_i64, _c_i64, _c_int, _c_int, _c_ptr,
                                    _c_ptr, _c_ptr),
}

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    the toolkit's default location."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> List[Path]:
    """The kernel sources, each compiled on its own."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librst_{digest.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the library now; returns its path and the compiler's
    output (``-Xptxas -v``: registers, shared memory and spills of each
    kernel).  Raises if nvcc fails."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        log, failed = "", []
        for src, proc in zip(srcs, procs):
            text, _ = proc.communicate()
            log += text
            if proc.returncode != 0:
                failed.append(
                    f"nvcc failed ({proc.returncode}) on {src}:\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({link.returncode}) linking {out}:\n"
                f"{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, log + link.stdout + link.stderr


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
