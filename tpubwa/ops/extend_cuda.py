"""Hopper extension kernel: ops/cuda/extend.cu through the XLA FFI.

Same contract as ops.extend._extend_core and exact to the cell: every field
of every lane equals ops.extend_ref.extend_ref.  One GPU thread runs one
extension job over its own band and stops at its own z-drop or zero row
(ops/cuda/extend_lane.h), so the whole target-row loop is one kernel
launch where the plain core is one ``lax.scan`` step per row.

The library is compiled with ``nvcc`` from the sources beside this module
at first use, into ``ops/cuda/build/`` under a name keyed by the sources,
the flags and the compiler; ``python -m tpubwa.ops.extend_cuda`` builds it
ahead of time.  Arguments are cast to int8/int32 before the call, so the
kernel is the same program with ``jax_enable_x64`` on.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from tpubwa.ops.extend import ExtendBatchResult, clamp_band_batch

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
TARGET = "tpubwa_extend"
I32 = jnp.int32


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA extension kernel needs the "
                       "CUDA toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> str:
    """Build (when no library for these sources, flags and compiler
    exists) and return the kernel library's path."""
    from tpubwa.native.build import keyed_build

    flags = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I",
             jax.ffi.include_dir())
    return keyed_build(_nvcc(), flags, [os.path.join(_DIR, "extend.cu")],
                       [os.path.join(_DIR, "extend_lane.h")],
                       os.path.join(_DIR, "build"), "libtpubwa_cuda")


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(library_path())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.TpubwaExtend),
                                platform="CUDA")


def kernel_args(query, qlen, target, tlen, mat, w, h0, end_bonus, *,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                mat_max: int):
    """The kernel's operands: int8 codes, int32 lane vectors with the band
    already clamped, and the matrix's (match, mismatch, N) scores."""
    mat = mat.astype(I32)
    qlen = qlen.astype(I32)
    w = clamp_band_batch(w.astype(I32), qlen, mat_max, o_del, e_del, o_ins,
                         e_ins, end_bonus.astype(I32)).astype(I32)
    sc = jnp.stack([mat[0, 0], mat[0, 1], mat[0, 4]])
    return (query.astype(jnp.int8), target.astype(jnp.int8), qlen,
            tlen.astype(I32), w, h0.astype(I32), sc)


def extend_core_cuda(query, qlen, target, tlen, mat, w, h0, end_bonus, *,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Traceable CUDA core with the contract of ops.extend._extend_core."""
    _register()
    args = kernel_args(query, qlen, target, tlen, mat, w, h0, end_bonus,
                       o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                       mat_max=mat_max)
    out = jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((6, query.shape[0]), I32))(
        *args, o_del=np.int32(o_del), e_del=np.int32(e_del),
        o_ins=np.int32(o_ins), e_ins=np.int32(e_ins), zdrop=np.int32(zdrop))
    return ExtendBatchResult(*out)


if __name__ == "__main__":
    print(library_path())
