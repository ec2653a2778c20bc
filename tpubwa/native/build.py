"""Build + load of the native host library (libtpubwa).

The C++ sources of this directory compile into one shared library, loaded
via ctypes.  Reference analog: the bwa-mem2 Makefile's native build
(SURVEY.md §2.1 "Build system"); here the native pieces are the host-side
runtime helpers (SA-IS index construction, seed chaining, SAM assembly)
around the JAX device compute path.

keyed_build names each built library by a hash of its sources, flags and
compiler, so a library built from other sources or by another compiler is
never loaded; the target is the portable x86-64 baseline (no -march=native),
because a checkout may be copied to another machine.  A failed build or
load raises with the compiler's message: the main path has no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
# the library's inputs, all tracked by git
SOURCES = ("sais.cpp", "chain.cpp", "extension.cpp", "samemit.cpp")
HEADERS = ("core.h",)
FLAGS = ("-O3", "-shared", "-fPIC")
_lib = None


def keyed_build(compiler: str, flags, sources, deps, out_dir: str,
                stem: str) -> str:
    """Compile ``sources`` into ``out_dir/<stem>-<key>.so`` unless it
    exists; the key hashes the sources, ``deps`` (headers), the flags and
    the compiler's version.  Returns the library's path."""
    version = subprocess.run([compiler, "--version"], check=True,
                             capture_output=True, text=True).stdout
    h = hashlib.sha256()
    for path in (*sources, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(version.encode())
    out = os.path.join(out_dir, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {stem} with {compiler} failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> str:
    return keyed_build(
        "g++", FLAGS, [os.path.join(_DIR, s) for s in SOURCES],
        [os.path.join(_DIR, h) for h in HEADERS],
        os.path.join(_DIR, "build"), "libtpubwa")


def load_native():
    """Build (if needed) and load the native library; raises on failure."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(library_path())
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib) -> None:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)

    lib.sais_u8.restype = c.c_int
    lib.sais_u8.argtypes = [u8p, i64p, c.c_int64, c.c_int64]

    lib.bwt_from_sa.restype = c.c_int
    lib.bwt_from_sa.argtypes = [u8p, i64p, c.c_int64, u8p, i64p]

    lib.chain_filter_batch.restype = c.c_int
    lib.chain_filter_batch.argtypes = [
        i64p, c.c_int64,          # seed_rows, n_seeds
        i64p, c.c_int64,          # read_bounds, n_reads
        u8p,                      # skip_read
        i64p, c.c_int64, c.c_int64,   # contig_offsets, n_contigs, l_pac
        c.c_int32, c.c_int32, c.c_int32, c.c_int64,  # w, gap, minw, maxext
        c.c_double, c.c_double, c.c_int32,  # mask_level, drop_ratio, minseed
        i32p, i32p, i32p, i64p, i64p, c.c_int64,  # outputs + cap
        i64p,                     # out_counts
    ]

    f64p = c.POINTER(c.c_double)
    lib.ext_prepare.restype = c.c_void_p
    lib.ext_prepare.argtypes = [
        i64p, c.c_int64,          # seed_rows, n_seeds
        i64p, c.c_int64,          # read_bounds, n_reads
        u8p,                      # skip_read
        i64p, c.c_int64, c.c_int64,   # contig_offsets, n_contigs, l_pac
        i32p, i32p,               # lens, l_rep
        c.c_int32, c.c_int32, c.c_int32, c.c_int64,  # w, gap, minw, maxext
        c.c_double, c.c_double, c.c_int32,  # mask_level, drop_ratio, minseed
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,  # a, gaps
        c.c_int32, c.c_int32,     # pen_clip5, pen_clip3
        i32p, i32p, i32p, i64p, i64p, i64p, i32p,  # job outputs
        c.c_int64, i64p,          # cap, out_counts
    ]
    lib.ext_finalize.restype = c.c_int
    lib.ext_finalize.argtypes = [
        c.c_void_p, i32p,         # handle, results [n_jobs, 14]
        i64p, i64p,               # reg_rb, reg_re
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # int32 reg fields
        f64p,                     # reg_frac_rep
        i64p, c.c_int64, i64p,    # reg_bounds, cap, out_counts
    ]
    lib.ext_free.restype = None
    lib.ext_free.argtypes = [c.c_void_p]

    lib.ext_phase1.restype = c.c_int64
    lib.ext_phase1.argtypes = [c.c_void_p, i64p]

    lib.ext_missing.restype = c.c_int64
    lib.ext_missing.argtypes = [c.c_void_p, i32p, u8p, i64p, c.c_int64]

    i8p = c.POINTER(c.c_int8)
    lib.sam_emit_se.restype = c.c_int64
    lib.sam_emit_se.argtypes = [
        c.c_int64,                      # B
        u8p, i64p,                      # other, other_off
        u8p, i64p, u8p, i64p, u8p, i64p,  # name/seq/qual bufs+offs
        u8p, i64p,                      # cname buf+off
        c.c_int64,                      # NL lanes
        u8p, i32p, i64p,                # rev, rid, pos1
        i32p, i32p,                     # clip5, clip3
        i32p, i32p, c.c_int64,          # cig_ns, cig_pack, ga_k
        i32p, i32p,                     # lead_d, trail_d
        i32p, u8p, u8p, c.c_int64,      # nm_in, mm_pos, mm_let, mm_k
        i32p, i32p,                     # lq, rlen
        i32p, i8p, i8p, c.c_int64, c.c_int64,  # win_row, qwin, twin, dims
        c.c_int64,                      # NR records
        i32p, i32p,                     # rec_b, rec_lane
        i32p, i32p, i32p, i32p,         # flag, mapq, score, xs
        i32p, i64p, i64p,               # rnext_rid, pnext, tlen
        i32p, i32p,                     # alt_lo, alt_hi
        u8p, c.c_int64,                 # out, out_cap
    ]
