"""Build and load the CUDA kernels (csrc/*.cu) for the H100 (sm_90a).

All sources compile with one nvcc call into one shared library with a
plain C interface, in the repo's git-ignored `build/cuda/` directory, at
first use; ctypes loads it. Nothing here runs at import. A missing nvcc
or a failed build raises: there is no fallback to the plain versions on
a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "cuda"
LIB_NAME = "libtilespmv_cuda.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argtypes); every entry returns cudaGetLastError()
ENTRY_POINTS = {
    "tsp_band": [_P] * 6 + [_I] * 3 + [_P],
    "tsp_dense": [_P] * 6 + [_I] * 4 + [_P],
    "tsp_sparse": [_P] * 6 + [_I] * 5 + [_P],
    "tsp_stream": [_P] * 10 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of nvcc: $NVCC, then PATH, then /usr/local/cuda/bin."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit on PATH)")


def build() -> pathlib.Path:
    """Compile csrc/*.cu into BUILD_DIR unless an up-to-date library is
    there; returns its path. Writes to a per-process name and renames
    into place, so concurrent builders never load a partial file."""
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / LIB_NAME
    if out.exists() and all(
            out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
