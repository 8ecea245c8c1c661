"""Smith-Waterman end positions through the CUDA kernel (native/sw_cuda.cu).

One kernel serves every device alignment of the GPU route: forward ends
for a batch of pairs, and start positions from the same kernel walking
the reversed prefixes (reverse=True). Each pair names a row of a score
profile table, so sequence queries (BLOSUM62 row plus composition bias)
and PSSM queries take the same call.

Inputs of `ends`:
  prof   (NP, A, LP) int16   profile table, prof[p, a, i] = score of
                             query row i against residue a; LP % 16 == 0
  pidx   (B,) int32          profile row per pair, < 0 for padding pairs
  tcodes (NT, LT) uint8      target residue codes (< A)
  tidx   (B,) int32          target row per pair
  nrows, ncols (B,) int32    walked query/target lengths
  rlast, clast (B,) int32    reverse only: the prefix ends q_end, t_end
Returns (score, row, col) in walk coordinates, row/col -1 when nothing
aligns. The DP contract is the one of ops/sw.py and ops/sw_jax.py.

The library is built from the committed sources into native/build/ at
first use, or ahead of time with

    python -m metaeuk_tpu.ops.sw_cuda

A build failure is an error; there is no fallback.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..data.submat import BLOSUM62_SCORES

_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
_SRCS = (_NATIVE / "sw_cuda.cu", _NATIVE / "sw_dp.h")
_SO = _NATIVE / "build" / "libsw_cuda.so"
TARGET = "metaeuk_sw_ends"
ROWS = 16  # profile rows per register stripe (sw_dp.h R)

_lock = threading.Lock()
_registered = False


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def build():
    """Compile the kernel library with nvcc for sm_90a."""
    _SO.parent.mkdir(exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-I", str(_NATIVE),
           "-o", str(tmp), str(_SRCS[0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("building the CUDA alignment kernel failed:\n"
                           + " ".join(cmd) + "\n" + res.stderr)
    os.replace(tmp, _SO)


def _stale():
    return (not _SO.exists()
            or _SO.stat().st_mtime < max(s.stat().st_mtime for s in _SRCS))


def register():
    """Build if needed and register the FFI target (idempotent)."""
    global _registered
    with _lock:
        if _registered:
            return
        if _stale():
            build()
        lib = ctypes.CDLL(str(_SO))
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SwEnds),
                                    platform="CUDA")
        _registered = True


def _out_shapes(B, LT):
    i32 = jax.ShapeDtypeStruct((B,), jnp.int32)
    return (i32, i32, i32, jax.ShapeDtypeStruct((LT, B, 2), jnp.int32))


def kernel_call(prof, pidx, tcodes, tidx, nrows, ncols, rlast, clast,
                reverse):
    """The FFI call itself (traced inside a jit)."""
    register()
    B, LT = pidx.shape[0], tcodes.shape[1]
    score, row, col, _ = jax.ffi.ffi_call(TARGET, _out_shapes(B, LT))(
        prof, pidx, tcodes, tidx, nrows, ncols, rlast, clast,
        reverse=np.int32(reverse))
    return score, row, col


def ends(prof, pidx, tcodes, tidx, nrows, ncols, rlast=None, clast=None,
         reverse=False):
    """(score, row, col) per pair; see the module docstring."""
    if prof.shape[2] % ROWS:
        raise ValueError(f"profile length {prof.shape[2]} is not a "
                         f"multiple of {ROWS}")
    zeros = jnp.zeros_like(nrows)
    return kernel_call(
        prof.astype(jnp.int16), pidx.astype(jnp.int32),
        tcodes.astype(jnp.uint8), tidx.astype(jnp.int32),
        nrows.astype(jnp.int32), ncols.astype(jnp.int32),
        zeros if rlast is None else rlast.astype(jnp.int32),
        zeros if clast is None else clast.astype(jnp.int32), reverse)


def seq_profile(q_mat, qb_mat):
    """(nq, A, Lq) int16 profile table of staged sequence queries:
    BLOSUM62[q_i, a] + bias_i."""
    sub = jnp.asarray(BLOSUM62_SCORES, jnp.int32)
    prof = sub[q_mat.astype(jnp.int32)] \
        + qb_mat.astype(jnp.int32)[:, :, None]          # (nq, Lq, A)
    return jnp.transpose(prof, (0, 2, 1)).astype(jnp.int16)


def pssm_profile(prof_mat):
    """(np, A, Lq) int16 profile table of (np, Lq, A) PSSMs."""
    return jnp.transpose(prof_mat, (0, 2, 1)).astype(jnp.int16)


def ends_host(prof, pidx, tcodes, tidx, nrows, ncols, rlast, clast,
              reverse):
    """The kernel's DP core built for the host (native/sw_host.cpp), on
    numpy arrays: the same arithmetic without a GPU."""
    from .. import native
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    prof = np.ascontiguousarray(prof, np.int16)
    tcodes = np.ascontiguousarray(tcodes, np.uint8)
    i32 = [np.ascontiguousarray(a, np.int32)
           for a in (pidx, tidx, nrows, ncols, rlast, clast)]
    pidx, tidx, nrows, ncols, rlast, clast = i32
    live = pidx >= 0
    if (np.any(pidx >= prof.shape[0]) or np.any(tidx[live] < 0)
            or np.any(tidx[live] >= tcodes.shape[0])
            or np.any(nrows[live] > prof.shape[2])
            or np.any(ncols[live] > tcodes.shape[1])
            or (reverse and (np.any(rlast[live] >= prof.shape[2])
                             or np.any(clast[live] >= tcodes.shape[1])))):
        raise ValueError("pair indices or lengths outside the tables")
    B = len(pidx)
    score = np.zeros(B, np.int32)
    row = np.zeros(B, np.int32)
    col = np.zeros(B, np.int32)
    lib.sw_ends_host(prof, prof.shape[1], prof.shape[2], i32[0], tcodes,
                     tcodes.shape[1], *i32[1:], B, int(bool(reverse)),
                     score, row, col)
    return score, row, col


def host_call(prof, pidx, tcodes, tidx, nrows, ncols, rlast, clast,
              reverse):
    """Drop-in for kernel_call that runs ends_host through a host
    callback: the kernel's wrappers then run end to end on the CPU."""
    B, LT = pidx.shape[0], tcodes.shape[1]

    def cb(*arrs):
        return ends_host(*arrs, reverse)

    return jax.pure_callback(cb, _out_shapes(B, LT)[:3], prof, pidx,
                             tcodes, tidx, nrows, ncols, rlast, clast)


if __name__ == "__main__":
    build()
    print(_SO)
