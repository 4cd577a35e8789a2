"""Build and load the CUDA kernels (csrc/*.cu) for the H100 (sm_90a).

Each source compiles in its own nvcc process, all started together, and
one more nvcc call links the objects into one shared library with a
plain C interface, in the repo's git-ignored `build/cuda/` directory, at
first use; ctypes loads it. Nothing here runs at import. A missing nvcc
or a failed build raises: there is no fallback to the plain versions on
a CUDA device. The probe scripts also build edited copies of a source
(`build_edited`, `arm_libs`), which the port never loads.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "cuda"
LIB_NAME = "libtilespmv_cuda.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_P = ctypes.c_void_p
_I = ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points: (name, argtypes); every entry returns a cudaError_t (0:
# success), a launch's being cudaGetLastError() right after it
ENTRY_POINTS = {
    "tsp_band": [_P] * 6 + [_I] * 3 + [_P],
    "tsp_dense": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "tsp_sparse": [_P] * 6 + [_I] * 6 + [_P],
    "tsp_stream": [_P] * 10 + [_I] * 4 + [_P],
    "tsp_band_f64": [_P] * 6 + [_I] * 3 + [_P],
    "tsp_dense_f64": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "tsp_stream_f64": [_P] * 10 + [_I] * 4 + [_P],
    "tsp_band_spmm": [_P] * 6 + [_I] * 4 + [_P],
    "tsp_dense_spmm": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "tsp_sparse_spmm": [_P] * 6 + [_I] * 7 + [_P],
    "tsp_stream2": [_P] * 10 + [_I] * 6 + [_P],
    "tsp_band_bf16": [_P] * 6 + [_I] * 3 + [_P],
    "tsp_dense_bf16": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "tsp_sparse_bf16": [_P] * 6 + [_I] * 6 + [_P],
    "tsp_stream_bf16": [_P] * 10 + [_I] * 4 + [_P],
    "tsp_band_spmm_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "tsp_dense_spmm_bf16": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "tsp_sparse_spmm_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "tsp_stream2_bf16": [_P] * 10 + [_I] * 6 + [_P],
    "tsp_mb_gather": [_P] * 3 + [_I] * 3 + [_P],
    "tsp_mb_gather_grid": [_I, _PI, _PI],
    "tsp_mb_scatter": [_P] * 3 + [_I] * 3 + [_P],
    "tsp_mb_scatter_grid": [_I, _PI, _PI],
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


def _run(cmd: list) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr[-8000:]}")


def build() -> pathlib.Path:
    """Compile csrc/*.cu into BUILD_DIR unless an up-to-date library is
    there; returns its path. Writes to per-process names and renames the
    library into place, so concurrent builds never load a partial
    file."""
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / LIB_NAME
    if out.exists() and all(
            out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    cus = [s for s in srcs if s.suffix == ".cu"]
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in cus]
    try:
        with ThreadPoolExecutor(len(cus)) as pool:
            for f in [pool.submit(_run, [nvcc, *NVCC_FLAGS, "-c", "-o",
                                         str(o), str(s)])
                      for s, o in zip(cus, objs)]:
                f.result()
        _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
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


def edit_once(src: str, old: str, new: str) -> str:
    """`src` with its one occurrence of `old` replaced by `new`; raises
    where `old` is not there exactly once (the source has changed)."""
    if src.count(old) != 1:
        raise RuntimeError(f"the kernel source no longer holds "
                           f"{old.strip()!r} once: update the probe")
    return src.replace(old, new)


def edit_const(src: str, name: str, value) -> str:
    """`src` with its one definition `constexpr int <name> = ...;` set to
    `value`, whatever the source sets it to now; raises where there is
    not exactly one."""
    pat = re.compile(rf"constexpr int {name} = [^;]*;")
    if len(pat.findall(src)) != 1:
        raise RuntimeError(f"the kernel source no longer defines {name} "
                           "once: update the probe")
    return pat.sub(f"constexpr int {name} = {value};", src)


_arms: dict = {}


def arm_libs(source: str, kept: str, edits: dict, entries) -> dict:
    """{arm: ctypes library} of a probe script's A/B of csrc/`source`:
    the port's own library as arm `kept`, and build_edited's copies,
    built on the first call of the process for that source."""
    if source not in _arms:
        _arms[source] = {kept: load(),
                         **build_edited(source, edits, entries)}
    return _arms[source]


def build_edited(source: str, edits: dict, entries) -> dict:
    """{name: ctypes library} of copies of csrc/`source`, each with
    edits[name] (a function of the source text) applied, built into
    BUILD_DIR/probes/ by one nvcc each, all started together; each
    library has the C signatures of `entries`. A library is loaded
    once a process: call this once and keep what it returns."""
    src = (CSRC_DIR / source).read_text()
    out = BUILD_DIR / "probes"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = pathlib.Path(source).stem
    jobs = {}
    for name, edit in edits.items():
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu, so = out / f"{stem}_{tag}.cu", out / f"{stem}_{tag}.so"
        cu.write_text(edit(src))
        jobs[name] = (cu, so)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(_run, [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR),
                                     "-shared", "-o", str(so), str(cu)])
                  for cu, so in jobs.values()]:
            f.result()
    libs = {}
    for name, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs
