"""Build and load the hand-written CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object file,
one process per source, all started together, and links them into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), under ``_build/<hash of sources and flags>/`` inside the
package; ``ctypes`` loads it. Each C entry takes device pointers and a
``cudaStream_t``, launches on that stream, allocates nothing and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x1, x1_pstride, x2, x2_pstride, params, ops, dims, degrees, orders,
    # cmask, fmask, out, P, N, M, D, C, F, stream
    "waveome_gram_forward": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _I, _P],
    # a, l, B, N, stream
    "waveome_chol_forward": [_P, _P, _I, _I, _P],
    # d, l, linv, B, stream
    "waveome_diag_factor_forward": [_P, _P, _P, _I, _P],
    # d, d_ld, d_bs, l, l_ld, l_bs, linv, i_ld, i_bs, B, stream
    "waveome_diag_factor_strided": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL,
                                    _LL, _I, _P],
}
# Entries that an older tree of sources may lack (tools/bench_kernels.py
# times such trees through the entries they share): left unset when
# missing, so that only a call to one raises.
_OPTIONAL = {"waveome_diag_factor_strided"}

_lib = None
# What the last build printed (nvcc's -Xptxas -v register and spill
# report) and how long it took; None when the library was already built.
build_log = None
build_seconds = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use and need the CUDA toolkit (set CUDA_HOME)")


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def build() -> str:
    """Compile the kernels if this source tree has not been built yet;
    return the path of the shared library."""
    global build_log, build_seconds
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libwaveome_kernels.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    if not failed:
        tmp = f"{so}.{tag}"
        cmd = [_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{log[-1]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(log)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            if name in _OPTIONAL and not hasattr(lib, name):
                continue
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.waveome_error_string.argtypes = [ctypes.c_int]
        lib.waveome_error_string.restype = ctypes.c_char_p
        for name in ("waveome_chol_max_n", "waveome_diag_factor_nb"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        msg = library().waveome_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
