#!/usr/bin/env python
"""End-to-end throughput benchmark: reads/sec on the visible GPUs.

Workload mirrors the reference's headline benchmark family (BASELINE.md:
1M x 150bp reads, Graviton4 16T => 130,378 reads/s end-to-end): an
E. coli-scale synthetic reference with 1%-error 150bp single-end reads
(error-injected so the DP path is live — SURVEY.md §4.5), full pipeline
FASTQ -> seeding -> chaining -> extension -> SAM text.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}

vs_baseline is measured reads/s divided by the reference's best measured
end-to-end number on its own headline workload (130,378 reads/s,
GRAVITON4_BENCHMARK_RESULTS.md:21-30 — a 16-vCPU machine).  Every
result names the device it ran on; without a CUDA GPU the bench exits
non-zero.  ``python bench.py --kernel`` times the extension DP core alone.

Env knobs: TPUBWA_BENCH_READS (default 20000), TPUBWA_BENCH_REF_MB
(default 4.6), TPUBWA_BENCH_PE=1 for paired-end.
"""
from __future__ import annotations

import functools
import io
import json
import os
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 130_378.0


def _work_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench")
    os.makedirs(d, exist_ok=True)
    return d


def _ensure_fixture(ref_mb: float, n_reads: int, pe: bool,
                    style: str = "random"):
    """Build (once, cached on disk) the synthetic reference + index + reads."""
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode

    d = _work_dir()
    ref_len = int(ref_mb * 1e6)
    tag0 = "" if style == "random" else f"_{style}"
    ref_fa = os.path.join(d, f"ref_{ref_len}{tag0}.fa")
    if not os.path.exists(ref_fa):
        rng = np.random.default_rng(42)
        if style == "chr21":
            from tpubwa.utils.gensim import repeat_genome

            codes = repeat_genome(rng, ref_len)
        else:
            codes = rng.integers(0, 4, ref_len).astype(np.uint8)
        with open(ref_fa, "w") as f:
            f.write(">benchref\n")
            seq = decode(codes)
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + "\n")
    if not FMIndex.exists(ref_fa):
        t = time.monotonic()
        FMIndex.from_fasta(ref_fa).save(ref_fa)
        print(f"[bench] index built in {time.monotonic()-t:.1f}s",
              file=sys.stderr)

    tag = ("pe" if pe else "se") + tag0
    fq1 = os.path.join(d, f"reads_{ref_len}_{n_reads}_{tag}_1.fq")
    fq2 = os.path.join(d, f"reads_{ref_len}_{n_reads}_{tag}_2.fq")
    if not os.path.exists(fq1):
        from tpubwa.io.fasta import read_fasta

        contigs, codes, _holes = read_fasta(ref_fa)
        if pe:
            r1, r2 = sim.simulate_pairs(codes, contigs, n_reads // 2,
                                        length=150, err=0.01, seed=7)
            sim.write_fastq(fq1, r1)
            sim.write_fastq(fq2, r2)
        else:
            reads = sim.simulate_reads(codes, contigs, n_reads, length=150,
                                       err=0.01, seed=7)
            sim.write_fastq(fq1, reads)
    return ref_fa, fq1, (fq2 if pe else None)


class _NullOut(io.TextIOBase):
    """SAM sink that still forces full text materialization."""

    def __init__(self) -> None:
        self.n_bytes = 0
        self.n_records = 0

    def write(self, s: str) -> int:  # type: ignore[override]
        self.n_bytes += len(s)
        self.n_records += s.count("\n")
        return len(s)


def require_gpu():
    """The first device, which must be a CUDA GPU: a speed measured on any
    other backend is not this program's.  Exits non-zero otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] needs a CUDA GPU; JAX's default platform is "
              f"{dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    return dev


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def kernel_lanes(shape: str, seed: int = 0):
    """Extension-core inputs (q, qlen, t, tlen, w, h0, end_bonus).

    "full": 4096 lanes, Q = T = 256, query == target, so no lane exits
    early and every band cell of every row is computed.
    "wave": the production wave shape (8192 lanes, Q = 192, T = 768, the
    ops.extend_flat pads): read-like lanes, a query of 0..150 bases at 1%
    substitutions against a target window of up to query + band bases."""
    from tpubwa.config import MemOptions

    rng = np.random.default_rng(seed)
    w0 = MemOptions().w
    if shape == "full":
        B, Q, T = 4096, 256, 256
        q = rng.integers(0, 4, (B, Q)).astype(np.int32)
        return (q, np.full(B, Q, np.int32), q.copy(), np.full(B, T, np.int32),
                np.full(B, w0, np.int32), np.full(B, 30, np.int32),
                np.full(B, 5, np.int32))
    B, Q, T = 8192, 192, 768
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(0, 151, B).astype(np.int32)
    tlen = np.minimum(qlen + w0 + rng.integers(0, 64, B), T).astype(np.int32)
    q = np.full((B, Q), 4, np.int32)
    q[:, :150] = t[:, :150]
    sub = rng.random((B, 150)) < 0.01
    q[:, :150][sub] = (q[:, :150][sub] + 1) % 4
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 4
    return (q, qlen, t, tlen, np.full(B, w0, np.int32),
            rng.integers(19, 60, B).astype(np.int32),
            np.full(B, 5, np.int32))


def time_core(core, lanes, reps: int = 5) -> float:
    """Median seconds of one jitted core call on ``lanes``, each call
    ended by block_until_ready (compile and first call excluded)."""
    import jax
    import jax.numpy as jnp

    from tpubwa.config import MemOptions
    from tpubwa.ops.extend import _extend_core

    opt = MemOptions()
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
    q, qlen, t, tlen, w, h0, eb = (jnp.asarray(a) for a in lanes)
    fn = jax.jit(functools.partial(core or _extend_core, **kw))
    args = (q, qlen, t, tlen, jnp.asarray(opt.score_matrix()), w, h0, eb)
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def band_cells(lanes) -> int:
    """DP cells inside the band over the rows each lane would run if it
    never stopped early: sum over rows i < tlen of |[i-w, i+w] ∩ [0, qlen)|
    (the w clamp of the core is ignored: a bound, for a rate)."""
    _q, qlen, _t, tlen, w, _h0, _eb = lanes
    total = 0
    for ql, tl, ww in zip(qlen.tolist(), tlen.tolist(), w.tolist()):
        i = np.arange(tl)
        total += int(np.clip(np.minimum(ql, i + ww + 1)
                             - np.maximum(0, i - ww), 0, None).sum())
    return total


def bench_kernel() -> int:
    """DP-core microbenchmark: the platform's core (ops.extend.select_core)
    against what XLA makes of the plain lax.scan core, on the "full" and
    "wave" lane sets (kernel_lanes).  Prints seconds and band Gcells/s per
    core, with the device kind and count; no peak share (an integer DP has
    no published peak on this card)."""
    from tpubwa.ops.extend import select_core

    dev = require_gpu()
    core = select_core(dev.platform)
    result = {"metric": "dp_core_band_gcells_per_sec", "unit": "Gcells/s",
              "device": device_info(), "shapes": {}}
    for shape in ("full", "wave"):
        lanes = kernel_lanes(shape)
        cells = band_cells(lanes)
        row = {}
        for name, c in (("kernel", core), ("xla", None)):
            dt = time_core(c, lanes)
            row[name] = {"seconds": dt, "gcells_per_sec": cells / dt / 1e9}
        row["speedup"] = row["xla"]["seconds"] / row["kernel"]["seconds"]
        result["shapes"][shape] = row
        print(f"[bench --kernel] {shape}: {len(lanes[1])} lanes, "
              f"Q={lanes[0].shape[1]} T={lanes[2].shape[1]}: kernel "
              f"{row['kernel']['seconds']*1e3:.3f} ms, XLA plain core "
              f"{row['xla']['seconds']*1e3:.3f} ms "
              f"(x{row['speedup']:.1f})", file=sys.stderr)
    result["value"] = result["shapes"]["full"]["kernel"]["gcells_per_sec"]
    print(json.dumps(result))
    return 0


def main() -> int:
    if "--kernel" in sys.argv:
        return bench_kernel()
    require_gpu()
    n_reads = int(os.environ.get("TPUBWA_BENCH_READS", "20000"))
    ref_mb = float(os.environ.get("TPUBWA_BENCH_REF_MB", "4.6"))
    pe = os.environ.get("TPUBWA_BENCH_PE", "0") == "1"
    style = os.environ.get("TPUBWA_BENCH_STYLE", "random")

    ref_fa, fq1, fq2 = _ensure_fixture(ref_mb, n_reads, pe, style=style)

    from tpubwa.config import MemOptions
    from tpubwa.utils.cache import enable_compile_cache

    enable_compile_cache()

    # warmup: compile every device program at the PRODUCTION batch shapes —
    # one full batch AND one tail-sized batch (the real run ends with
    # n_reads % batch_reads; its bucket shapes would otherwise compile
    # inside the timed region)
    threads_env = os.environ.get("TPUBWA_BENCH_THREADS", "1")  # serial
    # dispatch-ahead driver: measured faster than the thread pool (GIL)
    batch_sz = int(os.environ.get("TPUBWA_BENCH_BATCH", "0")) \
        or MemOptions.auto().batch_reads
    warm_n = batch_sz + (n_reads % batch_sz or batch_sz)
    warm_fq = os.path.join(_work_dir(), "warm.fq")
    with open(fq1) as f, open(warm_fq, "w") as w:
        for i, line in enumerate(f):
            if i >= 4 * warm_n:
                break
            w.write(line)
    threads = int(threads_env)
    batch_n = os.environ.get("TPUBWA_BENCH_BATCH")
    batch_n = int(batch_n) if batch_n else None

    # ONE Aligner for warmup + every timed pass: constructing per pass
    # re-uploads the device index and re-traces the jit caches — neither is
    # steady-state serving cost
    from tpubwa.align.pair import align_pe_fastq
    from tpubwa.align.pipeline import Aligner, run_se_pipeline
    from tpubwa.index.fmindex import FMIndex

    idx = FMIndex.load(ref_fa)
    opt = MemOptions.auto()
    if batch_n:
        opt.batch_reads = batch_n
    aligner = Aligner(idx, opt)

    def run_pass(fq_a, fq_b, sink):
        if pe and fq_b:
            return align_pe_fastq(aligner, fq_a, fq_b, sink,
                                  workers=threads)
        return run_se_pipeline(aligner, fq_a, sink, workers=threads)

    t = time.monotonic()
    if pe:
        warm2 = os.path.join(_work_dir(), "warm2.fq")
        with open(fq2) as f, open(warm2, "w") as w:
            for i, line in enumerate(f):
                if i >= 4 * warm_n:
                    break
                w.write(line)
        run_pass(warm_fq, warm2, _NullOut())
    else:
        run_pass(warm_fq, None, _NullOut())
    print(f"[bench] warmup (compile) {time.monotonic()-t:.1f}s",
          file=sys.stderr)

    # MEDIAN of three full passes; every pass is a complete end-to-end
    # alignment of all reads
    n_pass = int(os.environ.get("TPUBWA_BENCH_PASSES", "3"))
    times = []
    aligner.timers = type(aligner.timers)()  # timed-region phase profile
    for _p in range(n_pass):
        sink = _NullOut()
        t0 = time.monotonic()
        run_pass(fq1, fq2, sink)
        times.append(time.monotonic() - t0)
    times.sort()
    dt = times[len(times) // 2] if n_pass >= 3 else times[0]
    print("[bench] pass times: "
          + " ".join(f"{x:.2f}s" for x in times), file=sys.stderr)
    print(aligner.timers.report(), file=sys.stderr)

    rps = n_reads / dt
    result = {
        "device": device_info(),
        "metric": ("reads_per_sec_"
                   + ("pe" if pe else "se") + f"_{ref_mb:g}Mb"
                   + ("" if style == "random" else f"_{style}")
                   + "_150bp_err1pct"),
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 4),
    }
    print(f"[bench] {n_reads} reads in {dt:.2f}s -> {rps:.0f} reads/s "
          f"({sink.n_records} SAM lines)", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
