"""Build and load the port's CUDA kernels.

The sources under ``fluidgym_tpu_torch/csrc/`` compile into a plain-C
shared library (no PyTorch headers, so a build takes seconds, not minutes),
loaded with ``ctypes``: one ``nvcc -c`` per source, all started together,
then one link.  The library lands in
``<repo>/build/kernels/`` under a name keyed by a hash of the sources and
flags, so an unchanged tree never rebuilds.  Nothing happens at import: the
first kernel launch calls ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("cg.cu", "bicgstab_mb.cu", "stencil.cu")
HEADERS = ("krylov.cuh", "merged.cuh")
# --fmad=false: no contraction of a*b+c, so the kernels round every product
# and sum like the plain PyTorch versions do (only the order of the sums
# differs); the cost is invisible next to the iteration chain's latency
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_ARGTYPES = {
    # b, diag, off, x0, x, iters, rs, r, p, q, best, bar, slot, lanes,
    # chunk, resident, spread, chains, nz, ny, nx, ndims, op_per_lane, tol2,
    # maxiter, stall, precond, best?, warm, stream
    "fg_cg_solve": [_P] * 13 + [_I] * 10 + [_F] + [_I] * 5 + [_P],
    # b, diag, off, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
    # bar, slot, lanes, chunk, resident, spread, chains, nz, ny, nx, ndims,
    # op_per_lane, tol2, maxiter, stall, precond, best?, warm, stream
    "fg_bicgstab_solve": [_P] * 17 + [_I] * 10 + [_F] + [_I] * 5 + [_P],
    # ndims, spread, chains, n, out (int*)
    "fg_cg_spread_capacity": [_I] * 4 + [_P],
    "fg_bicgstab_spread_capacity": [_I] * 4 + [_P],
    # b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, bar, slot, lanes,
    # chunk, cluster, spread, chains, n, ndims, op_per_lane, tol2, maxiter,
    # stall, precond, best?, warm, stream
    "fg_cg_mb_solve": [_P] * 14 + [_I] * 8 + [_F] + [_I] * 5 + [_P],
    # b, diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t,
    # best, bar, slot, lanes, chunk, cluster, spread, chains, n, ndims,
    # op_per_lane, tol2, maxiter, stall, precond, best?, warm, stream
    "fg_bicgstab_mb_solve": [_P] * 18 + [_I] * 8 + [_F] + [_I] * 5 + [_P],
    # ndims, spread, chains, n, out (int*)
    "fg_cg_mb_spread_capacity": [_I] * 4 + [_P],
    "fg_bicgstab_mb_spread_capacity": [_I] * 4 + [_P],
    # ndims, cluster, n, out (int*)
    "fg_cg_mb_cluster_occupancy": [_I] * 3 + [_P],
    "fg_bicgstab_mb_cluster_occupancy": [_I] * 3 + [_P],
    # b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, einv_t, strip_ptr,
    # strip_cells, cidx, lanes, chunk, cluster, n, ndims, op_per_lane, K,
    # tol2, maxiter, stall, precond, best?, warm, stream
    "fg_cg_mb_coarse_solve": [_P] * 16 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
    # ndims, cluster, n, K (0: the strips), kp, stages, out (int*)
    "fg_cg_mb_coarse_cluster_occupancy": [_I] * 6 + [_P],
    # b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, einv, runs, cidx,
    # lanes, chunk, cluster, n, ndims, op_per_lane, K, kp, nruns, stages,
    # tol2, maxiter, stall, precond, best?, warm, stream
    "fg_cg_mb_agg_solve": [_P] * 15 + [_I] * 10 + [_F] + [_I] * 5 + [_P],
    # diag, off, x, hxm, hxp, hym, hyp, y, k, ny, nx, stream
    "fg_stencil2d_apply": [_P] * 8 + [_I] * 3 + [_P],
}


class _Library:
    """The loaded library plus what its build reported."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds: float | None = None  # None: reused a cached build
        self.build_log: str = ""


_LIB = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's "
                       "machine at first use (CUDA toolkit required)")


def _source_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    with _LIB._lock:
        if _LIB.lib is not None:
            return _LIB.lib
        out = BUILD_DIR / f"libfluidgym_kernels_{_source_key()}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{os.getpid()}.tmp"
            tmp = out.with_suffix(f".{tag}.so")
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs, procs = [], []
            for src in SOURCES:
                obj = BUILD_DIR / f"{Path(src).stem}.{tag}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(obj)
            logs, failed = [], []
            for cmd, proc in procs:
                log, _ = proc.communicate()
                logs.append(log)
                if proc.returncode != 0:
                    failed.append((cmd, proc.returncode))
            if not failed:
                cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                logs.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append((cmd, proc.returncode))
            for obj in objs:
                obj.unlink(missing_ok=True)
            _LIB.build_seconds = time.perf_counter() - t0
            _LIB.build_log = "".join(logs)
            if failed:
                cmd, rc = failed[0]
                raise RuntimeError(
                    f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{_LIB.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB.lib, _LIB.path = lib, out
        return lib


def build_info() -> dict:
    """Where the library is and how long its build took (None = cached)."""
    return {"path": str(_LIB.path) if _LIB.path else None,
            "build_seconds": _LIB.build_seconds, "log": _LIB.build_log}


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        import torch

        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError {status} "
            f"({torch.cuda.get_device_name()})")
