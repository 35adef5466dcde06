"""Build and load the CUDA kernels of ``aha_tpu_torch/csrc``.

The sources have a plain C interface and are compiled with ``nvcc`` straight
into one shared library, which is loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The library lands in ``build/aha_tpu_torch/``
beside the package, named by a hash of the sources and flags: a changed
source builds a new library at first use, an unchanged one is reused.

Nothing here runs at import time; ``library()`` builds on its first call.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aha_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build this process ran


def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (CUDA_HOME defaults to /usr/local/cuda), else
    the first nvcc on PATH."""
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if home.exists():
        return str(home)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of aha_tpu_torch cannot be built")
    return found


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs + sorted(CSRC.glob("*.cuh")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"libaha_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.aha_int8_matmul.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.aha_int8_matmul.restype = I
    lib.aha_decode_attention.argtypes = [P, P, P, P, P, P, P, P, P, P,
                                         I, I, I, I, I, I, I, I, F, P]
    lib.aha_decode_attention.restype = I
    lib.aha_error_string.argtypes = [I]
    lib.aha_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.aha_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
