"""Flat extension driver: chain + extend a whole read batch with two native
calls and ~one device call.

Pipeline shape (the VERDICT r2 "flatten the hot path" redesign):

  seed rows (host)
    -> native ext_prepare   : chain/filter every read + emit one job
                              descriptor per chain seed (native/extension.cpp)
    -> device extend_jobs   : gather q/t windows on device, fused
                              left+right band-doubling DP, one call per
                              wave (ops/extend_flat.py)
    -> native ext_finalize  : sequential containment replay -> regions

Semantically identical to the generator path (align/region.py extend_read
driven by run_extension_rounds) — pinned by tests/test_extend_flat.py.
"""
from __future__ import annotations

import ctypes

import numpy as np

from tpubwa.align.region import AlnReg
from tpubwa.config import MemOptions

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)

# wave lane-count buckets (pow2): small batches compile the small shapes,
# production batches run ceil(J / MAX_WAVE) full waves
MIN_WAVE = 256
MAX_WAVE = 8192


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def prepare_jobs(opt: MemOptions, l_pac: int, contig_offsets: np.ndarray,
                 seed_rows: np.ndarray, bounds: np.ndarray,
                 skip: np.ndarray, lens: np.ndarray, l_rep: np.ndarray):
    """native ext_prepare.  Returns (handle, jobs-dict, n_jobs)."""
    from tpubwa.native import load_native

    lib = load_native()
    seed_rows = np.ascontiguousarray(seed_rows, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    skip = np.ascontiguousarray(skip, dtype=np.uint8)
    offs = np.ascontiguousarray(contig_offsets, dtype=np.int64)
    lens = _i32(lens)
    l_rep = _i32(l_rep)
    n_seeds = len(seed_rows)
    n_reads = len(bounds) - 1
    cap = max(n_seeds, 1)
    jobs = {
        "read": np.empty(cap, np.int32),
        "qbeg": np.empty(cap, np.int32),
        "slen": np.empty(cap, np.int32),
        "rbeg": np.empty(cap, np.int64),
        "rmax0": np.empty(cap, np.int64),
        "rmax1": np.empty(cap, np.int64),
        "h0": np.empty(cap, np.int32),
    }
    counts = np.zeros(1, np.int64)
    handle = lib.ext_prepare(
        seed_rows.ctypes.data_as(_I64P), n_seeds,
        bounds.ctypes.data_as(_I64P), n_reads,
        skip.ctypes.data_as(_U8P),
        offs.ctypes.data_as(_I64P), len(offs), l_pac,
        lens.ctypes.data_as(_I32P), l_rep.ctypes.data_as(_I32P),
        opt.w, opt.max_chain_gap, opt.min_chain_weight,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio,
        opt.min_seed_len,
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.pen_clip5, opt.pen_clip3,
        jobs["read"].ctypes.data_as(_I32P),
        jobs["qbeg"].ctypes.data_as(_I32P),
        jobs["slen"].ctypes.data_as(_I32P),
        jobs["rbeg"].ctypes.data_as(_I64P),
        jobs["rmax0"].ctypes.data_as(_I64P),
        jobs["rmax1"].ctypes.data_as(_I64P),
        jobs["h0"].ctypes.data_as(_I32P),
        cap, counts.ctypes.data_as(_I64P))
    if not handle:
        raise RuntimeError("ext_prepare capacity exceeded")
    return handle, jobs, int(counts[0])


def run_waves(aligner, codes_dev, lens_dev, jobs: dict,
              n_jobs: int, lens_host=None) -> np.ndarray:
    """Run the extension device programs over the job list in pow2 waves;
    returns int32 [n_jobs, 14] results.  codes_dev/lens_dev are the device
    read batch (passed through, not stored — -t workers each carry their
    own batch).

    All waves are DISPATCHED before any result downloads, so the device
    queue never waits on a blocking (dispatch, download, dispatch, ...)
    round trip; downloads are started async (copy_to_host_async) so the
    per-wave transfers overlap.

    The LEFT and RIGHT extension halves run as SEPARATE wave streams,
    each sorted by its OWN effective depth (~min(tlen, qlen+w): a DP lane
    dies once its band passes the query end, and a group of lanes runs as
    long as its deepest) — jointly sorting by max(left, right) made a
    lane with a deep right window drag its shallow left group to the
    joint max.  The right stream seeds from the
    left stream's score0 (bwa's mem_chain2aln order), relayed through the
    host between streams.  Small batches (<= 512 jobs) keep the fused
    single-program path.  Results are returned in the original job
    order."""
    from tpubwa.ops.extend_flat import Q_PAD, T_PAD

    if n_jobs <= 512:
        return _run_waves_fused(aligner, codes_dev, lens_dev, jobs,
                                n_jobs)

    opt = aligner.opt
    w0 = opt.w
    jb = {k: v[:n_jobs] for k, v in jobs.items()}
    qb = jb["qbeg"].astype(np.int64)
    sl = jb["slen"].astype(np.int64)
    d_l = np.minimum(jb["rbeg"] - jb["rmax0"], T_PAD)
    d_r = np.minimum(jb["rmax1"] - jb["rbeg"] - sl, T_PAD)
    q_l = np.minimum(qb, Q_PAD)
    if lens_host is not None:
        q_r = np.minimum(np.asarray(lens_host)[jb["read"]] - qb - sl,
                         Q_PAD)
    else:
        q_r = Q_PAD
    rows_l = np.minimum(d_l, q_l + w0 + 1)
    rows_r = np.minimum(d_r, q_r + w0 + 1)
    ord_l = np.argsort(rows_l, kind="stable").astype(np.int64)
    ord_r = np.argsort(rows_r, kind="stable").astype(np.int64)

    out = np.empty((n_jobs, 14), np.int32)
    core = aligner.ext_core
    put = aligner._put

    def waves_of(order, fields, fn, ncols):
        """Dispatch fn over pow2 waves of the permuted job list; returns
        [(j0, take, device result)] in permuted coordinates."""
        res = []
        j0 = 0
        while j0 < n_jobs:
            take = min(n_jobs - j0, MAX_WAVE)
            W = MIN_WAVE
            while W < take:
                W <<= 1
            if 1024 < W < MAX_WAVE:
                W = MAX_WAVE // 2
            rows = order[j0:j0 + take]

            def pad(a):
                v = np.zeros(W, a.dtype)
                v[:take] = a[rows]
                return v

            r = fn([put(pad(f)) for f in fields])
            res.append((j0, take, r))
            j0 += take
        for _, _, r in res:
            r.copy_to_host_async()
        return res

    from tpubwa.ops.extend_flat import extend_jobs_left, extend_jobs_right

    kwl = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
               e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a, w0=w0,
               core=core)
    lw = waves_of(
        ord_l,
        [jb["read"], jb["qbeg"], jb["rbeg"], jb["rmax0"], jb["h0"]],
        lambda a: extend_jobs_left(aligner.di, codes_dev, lens_dev, *a,
                                   aligner.mat_dev,
                                   pen_clip5=opt.pen_clip5, **kwl),
        8)
    left8 = np.empty((n_jobs, 8), np.int32)
    for j0, take, r in lw:
        left8[ord_l[j0:j0 + take]] = np.asarray(r)[:, :take].T
    score0 = left8[:, 7].copy()

    rw = waves_of(
        ord_r,
        [jb["read"], jb["qbeg"], jb["slen"], jb["rbeg"], jb["rmax1"],
         score0.astype(np.int32)],
        lambda a: extend_jobs_right(aligner.di, codes_dev, lens_dev, *a,
                                    aligner.mat_dev,
                                    pen_clip3=opt.pen_clip3, **kwl),
        7)
    out[:, 0:6] = left8[:, 0:6]
    out[:, 12] = left8[:, 6]              # aw0
    for j0, take, r in rw:
        r7 = np.asarray(r)[:, :take].T
        rows = ord_r[j0:j0 + take]
        out[rows, 6:12] = r7[:, 0:6]
        out[rows, 13] = r7[:, 6]          # aw1
    return np.ascontiguousarray(out)


def _run_waves_fused(aligner, codes_dev, lens_dev, jobs: dict,
                     n_jobs: int) -> np.ndarray:
    """Single fused-program wave path (both extension halves in one
    device call) for small job lists."""
    out = np.empty((max(n_jobs, 1), 14), np.int32)
    core = aligner.ext_core
    waves = []  # (j0, take, device [14, W])
    j0 = 0
    while j0 < n_jobs:
        take = min(n_jobs - j0, MAX_WAVE)
        W = MIN_WAVE
        while W < take:
            W <<= 1
        if 1024 < W < MAX_WAVE:
            W = MAX_WAVE // 2
        sl = slice(j0, j0 + take)

        def pad(a):
            # dtype-preserving: rbeg/rmax columns are int64 (wide indexes
            # need the full width on device; narrow-mode jnp.asarray
            # downcasts to int32 at upload)
            v = np.zeros(W, a.dtype)
            v[:take] = a[sl]
            return v

        res = _call_extend(aligner, codes_dev, lens_dev, pad(jobs["read"]),
                           pad(jobs["qbeg"]), pad(jobs["slen"]),
                           pad(jobs["rbeg"]), pad(jobs["rmax0"]),
                           pad(jobs["rmax1"]), pad(jobs["h0"]), core)
        waves.append((j0, take, res))
        j0 += take
    for _, _, res in waves:
        res.copy_to_host_async()
    for j0, take, res in waves:
        out[j0:j0 + take] = np.asarray(res)[:, :take].T
    return np.ascontiguousarray(out)


def _call_extend(aligner, codes_dev, lens_dev, rd, qbeg, slen, rbeg, rmax0,
                 rmax1, h0, core):
    from tpubwa.ops.extend_flat import extend_jobs

    opt = aligner.opt
    put = aligner._put
    return extend_jobs(
        aligner.di, codes_dev, lens_dev,
        put(rd), put(qbeg), put(slen), put(rbeg), put(rmax0), put(rmax1),
        put(h0), aligner.mat_dev,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        zdrop=opt.zdrop, mat_max=opt.a, w0=opt.w,
        pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3, core=core)


def finalize_fields(handle, results: np.ndarray, n_reads: int,
                    n_jobs: int) -> tuple[dict, np.ndarray]:
    """native ext_finalize: containment replay -> flat per-region arrays
    (fields dict + bounds[n_reads+1]) — the flat SAM path consumes these
    directly (align/flatsam.py); finalize_regs wraps them into AlnReg
    lists for the generator path."""
    from tpubwa.native import load_native

    lib = load_native()
    results = np.ascontiguousarray(results, dtype=np.int32)
    cap = max(n_jobs, 1)
    fields: dict = {"rb": np.empty(cap, np.int64),
                    "re": np.empty(cap, np.int64)}
    for k in ("qb", "qe", "score", "truesc", "w", "seedcov", "rid",
              "seedlen0"):
        fields[k] = np.empty(cap, np.int32)
    fields["frac_rep"] = np.empty(cap, np.float64)
    bounds = np.empty(n_reads + 1, np.int64)
    counts = np.zeros(1, np.int64)
    rc = lib.ext_finalize(
        handle, results.ctypes.data_as(_I32P),
        fields["rb"].ctypes.data_as(_I64P),
        fields["re"].ctypes.data_as(_I64P),
        fields["qb"].ctypes.data_as(_I32P),
        fields["qe"].ctypes.data_as(_I32P),
        fields["score"].ctypes.data_as(_I32P),
        fields["truesc"].ctypes.data_as(_I32P),
        fields["w"].ctypes.data_as(_I32P),
        fields["seedcov"].ctypes.data_as(_I32P),
        fields["rid"].ctypes.data_as(_I32P),
        fields["seedlen0"].ctypes.data_as(_I32P),
        fields["frac_rep"].ctypes.data_as(_F64P),
        bounds.ctypes.data_as(_I64P), cap, counts.ctypes.data_as(_I64P))
    if rc != 0:
        raise RuntimeError("ext_finalize capacity exceeded")
    return fields, bounds


def finalize_regs(handle, results: np.ndarray, n_reads: int,
                  n_jobs: int) -> list[list[AlnReg]]:
    """native ext_finalize: containment replay -> list[list[AlnReg]]."""
    fields, bounds = finalize_fields(handle, results, n_reads, n_jobs)
    out: list[list[AlnReg]] = []
    for r in range(n_reads):
        regs = []
        for i in range(int(bounds[r]), int(bounds[r + 1])):
            regs.append(AlnReg(
                rb=int(fields["rb"][i]), re=int(fields["re"][i]),
                qb=int(fields["qb"][i]), qe=int(fields["qe"][i]),
                rid=int(fields["rid"][i]), score=int(fields["score"][i]),
                truesc=int(fields["truesc"][i]), w=int(fields["w"][i]),
                seedcov=int(fields["seedcov"][i]),
                seedlen0=int(fields["seedlen0"][i]),
                frac_rep=float(fields["frac_rep"][i])))
        out.append(regs)
    return out


def run_phased(aligner, codes_dev, lens_dev, handle, jobs: dict,
               n_jobs: int, lens_host=None) -> np.ndarray:
    """Phased extension rounds — bwa's sequential seed-skip recovered for
    batched device waves.

    bwa's mem_chain2aln extends a chain's seeds one at a time and SKIPS a
    seed when it is contained in an alignment built earlier (most chain
    seeds on repeat genomes — measured 11.2 speculative jobs/read vs
    ~4 chains/read on the chr21-style fixture).  Running every
    speculative job up-front (round 4's scheme) wastes that skip.  The
    phased protocol: round 1 runs the first-visited seed of every chain
    (native ext_phase1); the native replay (ext_missing) then re-walks
    the reads with the available results and returns exactly the jobs a
    further round must run (greedy per read, so it terminates in <= 3
    rounds); ext_finalize's exact sequential replay never reads a slot
    that was not run.  Output is BIT-IDENTICAL to running all jobs
    (tests/test_extend_flat.py::test_phased_matches_full)."""
    import ctypes as c

    from tpubwa.native import load_native

    lib = load_native()
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)
    u8p = c.POINTER(c.c_uint8)

    results = np.zeros((max(n_jobs, 1), 14), np.int32)
    have = np.zeros(max(n_jobs, 1), np.uint8)
    ids = np.empty(max(n_jobs, 1), np.int64)
    n1 = lib.ext_phase1(handle, ids.ctypes.data_as(i64p))
    run = ids[:n1].copy()
    rounds = 0
    while run.size:
        sub = {k: np.ascontiguousarray(v[:n_jobs][run])
               for k, v in jobs.items()}
        res = run_waves(aligner, codes_dev, lens_dev, sub, run.size,
                        lens_host=lens_host)
        results[run] = res
        have[run] = 1
        rounds += 1
        n_miss = lib.ext_missing(
            handle, results.ctypes.data_as(i32p),
            have.ctypes.data_as(u8p), ids.ctypes.data_as(i64p),
            len(ids))
        if n_miss < 0:
            raise RuntimeError("ext_missing capacity exceeded")
        run = ids[:n_miss].copy()
    return results
