#!/usr/bin/env python
"""Smoke run of the aligner's main path on one CUDA GPU.

    python chip_smoke.py            # one card: phases 0-6 below
    python chip_smoke.py --four     # four cards: only the path across cards

Run from the repository root.  One process uses the card (phase 6's test
child runs to its end before this process first opens the card).  Every
phase prints one line; any failure ends the run with a non-zero exit and no
result line.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Working size: the chr21-style 46 Mb repeat genome (tpubwa.utils.gensim
.repeat_genome, seed 42: 8 segmental copies at 2% divergence and a
high-copy Alu-like element), indexed on the card (about 92 M text rows);
150 bp reads at 1% error from the built-in simulator: three full device
batches single-end, one full batch of pairs.

0. card: nvidia-smi name and power limit; JAX's devices (must be gpu).
1. native library build/load; genome; ``tpu-bwa index`` (seconds each).
2. kernels against their references at real widths, exactly: the
   extension core (all lanes against the plain core on the CPU backend,
   512 sampled lanes against extend_ref), localsw_batch, the CIGAR DP and
   FM backward search; the extension program's memory analysis.
3. SE ``tpu-bwa mem``: cold compile seconds, smoke reads/s (not a
   benchmark), phase table, overflow and declined reads, mapped and
   near-truth fractions; a 512-read subsample byte-identical to the CPU
   backend and to the CLI's own records.
4. PE ``tpu-bwa mem``: the same, with the proper-pair fraction; a 256-pair
   subsample byte-identical to the CPU backend.
5. sampled SA (--sa-shift 4), then the wide int64 layout under x64: the
   SE subsample identical to phase 3's.
6. the ``gpu``-marked tests, in a child process with JAX_PLATFORMS=cuda.

--four: SE and PE on a four-card "dp" mesh and the sharded-SA leg
(ops.fm.sa_lookup_sharded), each byte-compared with the one-card SAM made
in the same process.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
GENOME_LEN = 46_000_000
GENOME_SEED = 42
BATCH = 8192              # the gpu preset's reads per card
SE_READS = 3 * BATCH
PE_PAIRS = BATCH
SUB_SE, SUB_PE = 512, 256
REF_LANES = 512           # extension lanes checked against extend_ref


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ phase 0 ----

def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except FileNotFoundError:
        fail("nvidia-smi not found: no NVIDIA GPU on this machine")
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def gpu_tests() -> str:
    """Phase 6, run first: the gpu-marked tests in a child that owns the
    card until it exits."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    check(proc.returncode == 0 and " passed" in tail[0]
          and "skipped" not in tail[0],
          f"gpu-marked tests: rc={proc.returncode}\n{proc.stdout[-4000:]}"
          f"\n{proc.stderr[-2000:]}")
    return f"{tail[0]} in {time.monotonic() - t0:.1f}s"


def init_jax():
    # the CPU backend is opened beside the card for the reference runs
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax

    from tpubwa.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX's default platform is {devs[0].platform!r}, not gpu")
    return jax, devs, cache


# ------------------------------------------------------------ phase 1 ----

def build_inputs(n_se: int, n_pairs: int) -> dict:
    import numpy as np

    from tpubwa.cli import main as cli
    from tpubwa.io.fasta import Contig
    from tpubwa.native import build
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode
    from tpubwa.utils.gensim import repeat_genome

    os.makedirs(WORK, exist_ok=True)
    t = {}
    t0 = time.monotonic()
    build.load_native()
    t["native"] = time.monotonic() - t0
    lib = os.path.basename(build.library_path())
    t0 = time.monotonic()
    codes = repeat_genome(np.random.default_rng(GENOME_SEED), GENOME_LEN)
    ref = os.path.join(WORK, "chr21like.fa")
    seq = decode(codes)
    with open(ref, "w") as f:
        f.write(">chr21like\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    del seq
    t["genome"] = time.monotonic() - t0
    t0 = time.monotonic()
    check(cli(["index", ref]) == 0, "tpu-bwa index failed")
    t["index"] = time.monotonic() - t0
    t0 = time.monotonic()
    contigs = [Contig("chr21like", GENOME_LEN, 0)]
    se = os.path.join(WORK, "se.fq")
    sim.write_fastq(se, sim.simulate_reads(codes, contigs, n_se, length=150,
                                           err=0.01, seed=7))
    r1, r2 = sim.simulate_pairs(codes, contigs, n_pairs, length=150,
                                err=0.01, seed=11)
    pe1, pe2 = (os.path.join(WORK, f"pe_{k}.fq") for k in (1, 2))
    sim.write_fastq(pe1, r1)
    sim.write_fastq(pe2, r2)
    t["reads"] = time.monotonic() - t0
    say(f"[1/6] native library {lib} in {t['native']:.1f}s; genome "
        f"{GENOME_LEN} bp (seed {GENOME_SEED}) in {t['genome']:.1f}s; "
        f"tpu-bwa index in {t['index']:.1f}s; reads ({n_se} SE, {n_pairs} "
        f"pairs) in {t['reads']:.1f}s")
    return dict(ref=ref, se=se, pe1=pe1, pe2=pe2)


# ------------------------------------------------------------ phase 2 ----

def _ref_lane(args):
    from tpubwa.config import MemOptions
    from tpubwa.ops.extend_ref import extend_ref

    q, t, w, h0, eb = args
    o = MemOptions()
    r = extend_ref(q, t, o.score_matrix(), o.o_del, o.e_del, o.o_ins,
                   o.e_ins, w, eb, o.zdrop, h0)
    return (r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off)


def _localsw_lane(args):
    from tpubwa.config import MemOptions
    from tpubwa.ops.localsw import localsw_ref

    q, t, minsc = args
    o = MemOptions()
    return localsw_ref(q, t, o.score_matrix(), o.o_del, o.e_del, o.o_ins,
                       o.e_ins, minsc=minsc)


def _global_lane(args):
    from tpubwa.config import MemOptions
    from tpubwa.ops.global_align import global_align

    q, t, w = args
    o = MemOptions()
    return global_align(q, t, o.score_matrix(), o.o_del, o.e_del, o.o_ins,
                        o.e_ins, w)


def mixed_lanes(B: int, Q: int, T: int, seed: int):
    """Q = max_read_len lanes of mixed lengths, band widths 3/10/100/200,
    zero-length lanes, 1% substitutions and the odd N."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(0, Q + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, T, B), T).astype(np.int32)
    q = t[:, :Q].copy()
    sub = rng.random((B, Q)) < 0.01
    q[sub] = (q[sub] + 1) % 4
    q[rng.random((B, Q)) < 0.002] = 4
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 4
    qlen[::97] = 0
    tlen[5::101] = 0
    w = np.array([3, 10, 100, 200], np.int32)[np.arange(B) % 4]
    return (q, qlen, t, tlen, w, rng.integers(1, 60, B).astype(np.int32),
            np.full(B, 5, np.int32))


def check_kernels(jax, pool) -> str:
    import jax.numpy as jnp
    import numpy as np

    import bench
    from tpubwa.config import MemOptions
    from tpubwa.ops.extend import _extend_core, select_core
    from tpubwa.ops.global_align import (global_align_cigar_batch,
                                         steps_to_cigar)
    from tpubwa.ops.localsw import BIG, localsw_batch

    opt = MemOptions()
    mat = opt.score_matrix()
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
    gaps = {k: kw[k] for k in ("o_del", "e_del", "o_ins", "e_ins")}
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    core = select_core(gpu.platform)
    check(core is not None, "no GPU extension core selected")

    def on(dev, fn, arrays):
        with jax.default_device(dev):
            out = fn(*[jax.device_put(np.asarray(a), dev) for a in arrays])
            return jax.tree.map(np.asarray, out)

    notes = []
    rng = np.random.default_rng(3)
    ext_gpu = jax.jit(lambda *a: core(*a, **kw))
    ext_cpu = jax.jit(lambda *a: _extend_core(*a, **kw))
    mem = None
    for kind, lanes in (("full", bench.kernel_lanes("full")),
                        ("mixed", mixed_lanes(4096, 160, 320, seed=5))):
        q, qlen, t, tlen, w, h0, eb = lanes
        name = f"{kind} B={q.shape[0]} Q={q.shape[1]} T={t.shape[1]}"
        args = (q, qlen, t, tlen, mat, w, h0, eb)
        got = np.stack(on(gpu, ext_gpu, args))
        want = np.stack(on(cpu, ext_cpu, args))
        bad = int((got != want).any(0).sum())
        check(bad == 0, f"extension {name}: {bad} lanes differ from the "
                        "plain core on the CPU backend")
        pick = rng.choice(len(qlen), REF_LANES // 2, replace=False)
        refs = pool.map(_ref_lane, [
            (q[b, :qlen[b]].astype(np.uint8), t[b, :tlen[b]].astype(np.uint8),
             int(w[b]), int(h0[b]), int(eb[b])) for b in pick])
        check(np.array_equal(got[:, pick].T, np.array(refs)),
              f"extension {name}: sampled lanes differ from extend_ref")
        if mem is None:
            with jax.default_device(gpu):
                mem = ext_gpu.lower(*[jnp.asarray(a) for a in args]
                                    ).compile().memory_analysis()
        notes.append(f"ext {name}: {len(qlen)} lanes = CPU plain core, "
                     f"{len(pick)} = extend_ref")

    # mate-rescue local SW at rescue widths: read vs insert-size window
    B, Q, T = 2048, 160, 512
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = rng.integers(Q, T + 1, B).astype(np.int32)
    q = np.full((B, Q), 4, np.int32)
    for b in range(B):
        if b % 3:
            s = int(rng.integers(0, tlen[b] - qlen[b] + 1))
            q[b, :qlen[b]] = t[b, s:s + qlen[b]]
            q[b, rng.integers(0, qlen[b])] = rng.integers(0, 5)
        else:
            q[b, :qlen[b]] = rng.integers(0, 4, qlen[b])
    minsc = rng.integers(0, 40, B).astype(np.int32)
    endsc = np.full(B, BIG, np.int32)
    lsw = jax.jit(lambda *a: localsw_batch(*a, **gaps))
    args = (q, qlen, t, tlen, mat, minsc, endsc)
    got = np.stack(on(gpu, lsw, args))
    check(np.array_equal(got, np.stack(on(cpu, lsw, args))),
          "localsw_batch differs from the CPU backend")
    pick = rng.choice(B, 64, replace=False)
    refs = pool.map(_localsw_lane, [
        (q[b, :qlen[b]].astype(np.uint8), t[b, :tlen[b]].astype(np.uint8),
         int(minsc[b])) for b in pick])
    check(np.array_equal(got[:, pick].T, np.array(refs)),
          "localsw_batch differs from localsw_ref")
    notes.append(f"localsw {B}x{Q}x{T}: all = CPU, 64 = localsw_ref")

    # CIGAR DP at the SAM stage's widths: query vs reference span
    B, Q, T = 2048, 160, 192
    qs, ts, ws = [], [], []
    q = np.zeros((B, Q), np.int32)
    t = np.zeros((B, T), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    w = np.zeros(B, np.int32)
    for b in range(B):
        tt = rng.integers(0, 4, int(rng.integers(100, T + 1)))
        qq = [c for c in tt if rng.random() > 0.01]
        qq = np.array([(c + 1) % 4 if rng.random() < 0.02 else c
                       for c in qq][:Q], np.int32)
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        qlen[b], tlen[b] = len(qq), len(tt)
        w[b] = abs(len(qq) - len(tt)) + int(rng.integers(3, 40))
    ga = jax.jit(lambda *a: global_align_cigar_batch(*a, **gaps))
    args = (q, qlen, t, tlen, mat, w)
    got = on(gpu, ga, args)
    want = on(cpu, ga, args)
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "global_align_cigar_batch differs from the CPU backend")
    pick = rng.choice(B, 64, replace=False)
    refs = pool.map(_global_lane, [
        (q[b, :qlen[b]].astype(np.uint8), t[b, :tlen[b]].astype(np.uint8),
         int(w[b])) for b in pick])
    for b, (s_ref, cig_ref) in zip(pick, refs):
        check(int(got.score[b]) == s_ref
              and steps_to_cigar(got.steps[b]) == cig_ref,
              f"CIGAR DP lane {b} differs from global_align")
    notes.append(f"cigar DP {B}x{Q}x{T}: all = CPU, 64 = global_align")
    return "; ".join(notes), mem


def check_fm(jax, ref: str) -> str:
    """Device backward search of 4096 32-mers (3/4 from the genome) against
    fm_ref, on the 46 Mb index."""
    import jax.numpy as jnp
    import numpy as np

    from tpubwa.index.fmindex import FMIndex
    from tpubwa.ops import fm, fm_ref

    idx = FMIndex.load(ref)
    di = fm.DeviceIndex.from_host(idx)
    rng = np.random.default_rng(9)
    n, L = 4096, 32
    text = np.concatenate([idx.fetch_ref(0, idx.l_pac)])
    pats = rng.integers(0, 4, (n, L)).astype(np.int32)
    starts = rng.integers(0, idx.l_pac - L, n)
    real = np.arange(n) % 4 != 0
    pats[real] = text[starts[real, None] + np.arange(L)[None, :]]

    @jax.jit
    def search(di, pats):
        ik = fm.set_intv(di, pats[:, -1])

        def step(ik, c):
            ext = fm.backward_ext_all(di, ik, True)
            pick = lambda a: jnp.take_along_axis(  # noqa: E731
                a, c[:, None], axis=1)[:, 0]
            return fm.BiInterval(k=pick(ext.k), l=pick(ext.l),
                                 s=pick(ext.s)), None

        ik, _ = jax.lax.scan(step, ik, pats[:, -2::-1].T)
        return ik

    got = search(di, jnp.asarray(pats))
    got = np.stack([np.asarray(got.k), np.asarray(got.l), np.asarray(got.s)])
    for b in rng.choice(n, 256, replace=False):
        k, l, s = fm_ref.set_intv(idx, int(pats[b, -1]))
        for c in pats[b, -2::-1]:
            k, l, s = fm_ref.backward_ext_all(idx, k, l, s, True)[int(c)]
        check(tuple(int(x) for x in got[:, b]) == (k, l, s),
              f"FM backward search pattern {b} differs from fm_ref")
    check((got[2][real] > 0).all(), "a genome 32-mer was not found")
    return f"FM search {n}x{L}-mers: 256 = fm_ref, all genome k-mers found"


# ---------------------------------------------------------- phases 3-5 ----

def run_cli(argv: list[str], sam: str) -> tuple[float, str]:
    """tpu-bwa through tpubwa.cli.main, SAM to a file; returns (seconds,
    captured stderr)."""
    from tpubwa.cli import main as cli

    err = io.StringIO()
    t0 = time.monotonic()
    with open(sam, "w") as out, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli(argv)
    dt = time.monotonic() - t0
    check(rc == 0, f"tpu-bwa {' '.join(argv)}: rc={rc}\n"
                   f"{err.getvalue()[-3000:]}")
    return dt, err.getvalue()


def phase_table(err: str) -> str:
    rows = re.findall(r"^\s+(\w+): ([\d.]+) \(n=\d+\)$", err, re.M)
    return " ".join(f"{k}={v}s" for k, v in rows)


def engine_counts(err: str) -> tuple[int, int]:
    m = re.findall(r"flat engine: (\d+) reads finalized, (\d+) declined",
                   err)
    check(m, "no flat-engine report on stderr")
    return int(m[-1][0]), int(m[-1][1])


def body(sam: str) -> list[str]:
    with open(sam) as f:
        return [ln for ln in f if not ln.startswith("@")]


def truth_stats(lines: list[str], pe: bool) -> dict:
    n = mapped = near = proper = 0
    for ln in lines:
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        n += 1
        if flag & 4:
            continue
        mapped += 1
        proper += bool(flag & 2)
        p = f[0].split("_")
        truth = (int(p[4]) if (pe and flag & 128) else int(p[3])) + 1
        near += abs(int(f[3]) - truth) <= 12
    return dict(n=n, mapped=mapped / n, near=near / n, proper=proper / n)


def subsample(path: str, n: int) -> list:
    from tpubwa.io.fastq import read_fastq

    out = []
    for r in read_fastq(path):
        out.append(r)
        if len(out) == n:
            return out
    return out


def se_text(jax, idx, device, reads, **opt_kw) -> str:
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.io.fastq import batch_reads

    with jax.default_device(device):
        opt = MemOptions.preset(device.platform, batch_reads=len(reads),
                                **opt_kw)
        al = Aligner(idx, opt)
        batch = next(batch_reads(reads, len(reads), opt.max_read_len))
        return al.align_se_text(batch, 0)


def pe_text(jax, idx, device, r1, r2) -> str:
    from tpubwa.align.pair import align_pe_batch
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.io.fastq import batch_reads

    with jax.default_device(device):
        opt = MemOptions.preset(device.platform, batch_reads=len(r1))
        al = Aligner(idx, opt)
        b1 = next(batch_reads(r1, len(r1), opt.max_read_len))
        b2 = next(batch_reads(r2, len(r2), opt.max_read_len))
        return align_pe_batch(al, b1, b2, 0)


def one_card(args) -> dict:
    import multiprocessing as mp

    say(f"[0/6] card: {card_line()}")
    say(f"[6/6] gpu-marked tests (child, JAX_PLATFORMS=cuda, before this "
        f"process opens the card): {gpu_tests()}")
    jax, devs, cache = init_jax()
    say(f"[0/6] jax {jax.__version__}: {len(devs)}x {devs[0].platform} "
        f"({devs[0].device_kind}); compile cache {cache}")
    check(len(devs) == 1, f"one card expected, JAX sees {len(devs)}; "
                          "set CUDA_VISIBLE_DEVICES")
    files = build_inputs(SE_READS, PE_PAIRS)

    with mp.get_context("spawn").Pool(min(16, os.cpu_count() or 1)) as pool:
        t0 = time.monotonic()
        notes, mem = check_kernels(jax, pool)
    notes += "; " + check_fm(jax, files["ref"])
    say(f"[2/6] kernels exact in {time.monotonic() - t0:.1f}s: {notes}; "
        f"extension program memory: {mem}")

    gpu = devs[0]
    cpu = jax.devices("cpu")[0]
    from tpubwa.index.fmindex import FMIndex

    # ---- SE
    sam = os.path.join(WORK, "se.sam")
    cold, err = run_cli(["mem", files["ref"], files["se"]], sam)
    warm, err = run_cli(["mem", files["ref"], files["se"]], sam)
    lines = body(sam)
    st = truth_stats(lines, pe=False)
    n_fin, n_dec = engine_counts(err)
    ovf = re.findall(r"(\d+) read\(s\) exceeded", err)
    idx = FMIndex.load(files["ref"])
    reads = subsample(files["se"], SUB_SE)
    sub_gpu = se_text(jax, idx, gpu, reads)
    sub_cpu = se_text(jax, idx, cpu, reads)
    names = {r.name for r in reads}
    cli_sub = "".join(ln for ln in lines if ln.split("\t")[0] in names)
    peak = (gpu.memory_stats() or {}).get("peak_bytes_in_use")
    say(f"[3/6] SE {SE_READS} reads: cold run {cold:.1f}s, warm {warm:.1f}s "
        f"-> cold compile ~{cold - warm:.1f}s (cache {cache}); smoke figure, "
        f"not a benchmark: {SE_READS / warm:.0f} reads/s; phases "
        f"{phase_table(err)}; n_overflow {sum(map(int, ovf))}; flat engine "
        f"{n_fin} reads, declined {n_dec} ({n_dec / max(n_fin, 1):.4f}); "
        f"mapped {st['mapped']:.4f}, near truth {st['near']:.4f}; "
        f"{SUB_SE}-read subsample GPU == CPU: {sub_gpu == sub_cpu}, "
        f"== CLI records: {sub_gpu == cli_sub}; peak device bytes {peak}")
    check(st["n"] == SE_READS, f"{st['n']} primary records, not {SE_READS}")
    check(st["mapped"] >= 0.97, f"SE mapped {st['mapped']:.4f} < 0.97")
    check(n_fin > 0, "the flat engine did not run")
    check(sub_gpu == sub_cpu, "SE subsample SAM differs from the CPU backend")
    check(sub_gpu == cli_sub, "SE subsample SAM differs from the CLI run")

    # ---- PE
    sam_pe = os.path.join(WORK, "pe.sam")
    cold_pe, err = run_cli(["mem", files["ref"], files["pe1"], files["pe2"]],
                           sam_pe)
    warm_pe, err = run_cli(["mem", files["ref"], files["pe1"], files["pe2"]],
                           sam_pe)
    st_pe = truth_stats(body(sam_pe), pe=True)
    n_fin, n_dec = engine_counts(err)
    r1, r2 = subsample(files["pe1"], SUB_PE), subsample(files["pe2"], SUB_PE)
    pe_gpu = pe_text(jax, idx, gpu, r1, r2)
    pe_cpu = pe_text(jax, idx, cpu, r1, r2)
    say(f"[4/6] PE {PE_PAIRS} pairs: cold run {cold_pe:.1f}s, warm "
        f"{warm_pe:.1f}s; smoke figure: {2 * PE_PAIRS / warm_pe:.0f} reads/s; "
        f"phases {phase_table(err)}; flat engine {n_fin} reads, declined "
        f"{n_dec} ({n_dec / max(n_fin, 1):.4f}); mapped {st_pe['mapped']:.4f}, "
        f"near truth {st_pe['near']:.4f}, proper pairs {st_pe['proper']:.4f}; "
        f"{SUB_PE}-pair subsample GPU == CPU: {pe_gpu == pe_cpu}")
    check(st_pe["n"] == 2 * PE_PAIRS, "PE primary record count")
    check(n_fin > 0, "the flat engine did not run (PE)")
    check(pe_gpu == pe_cpu, "PE subsample SAM differs from the CPU backend")

    # ---- sampled SA, then the wide layout (x64 is process-global: last)
    sampled = se_text(jax, idx, gpu, reads, sa_sample_shift=4)
    check(sampled == sub_gpu, "--sa-shift 4 SAM differs from phase 3")
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.io.fastq import batch_reads
    from tpubwa.ops.fm import DeviceIndex

    jax.config.update("jax_enable_x64", True)
    opt = MemOptions.preset("gpu", batch_reads=SUB_SE)
    al = Aligner(idx, opt)
    al.di = DeviceIndex.from_host(idx, wide=True)
    check(al.di.sa.dtype == jax.numpy.int64, "wide layout is not int64")
    batch = next(batch_reads(reads, SUB_SE, opt.max_read_len))
    wide = al.align_se_text(batch, 0)
    check(wide == sub_gpu, "wide int64 layout SAM differs from phase 3")
    say(f"[5/6] sampled SA (shift 4) and wide int64 layout (x64 on, CUDA "
        f"core): {SUB_SE}-read subsample identical to phase 3")
    return {"platform": gpu.platform, "kind": gpu.device_kind,
            "count": len(devs)}


def four_cards(args) -> dict:
    from tpubwa.align.pair import align_pe_fastq
    from tpubwa.align.pipeline import Aligner, run_se_pipeline
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex

    say(f"[0/3] cards: {' | '.join(card_line().splitlines())}")
    jax, devs, cache = init_jax()
    check(len(devs) == 4, f"four cards expected, JAX sees {len(devs)}")
    say(f"[0/3] jax {jax.__version__}: {len(devs)}x {devs[0].platform} "
        f"({devs[0].device_kind}); compile cache {cache}")
    # the four-card preset's batch (8192 reads per card) for every leg, on
    # one card too: the options differ only in the mesh (PE insert-size
    # statistics are per batch)
    four = MemOptions.preset("gpu", 4)
    B = four.batch_reads
    check(four.mesh_shape == (4,) and B == 4 * BATCH, "four-card preset")
    one = MemOptions.preset("gpu", 1, batch_reads=B)
    sharded = MemOptions.preset("gpu", 4, shard_sa=True)
    files = build_inputs(B, BATCH)
    idx = FMIndex.load(files["ref"])

    def run(opt, fqs):
        sink = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stderr(io.StringIO()):
            if len(fqs) == 1:
                run_se_pipeline(Aligner(idx, opt), fqs[0], sink)
            else:
                align_pe_fastq(Aligner(idx, opt), *fqs, sink)
        return sink.getvalue(), time.monotonic() - t0

    se1, t1 = run(one, [files["se"]])
    se4, t4 = run(four, [files["se"]])
    say(f"[1/3] SE {B} reads, dp mesh of 4 == one card: {se4 == se1} "
        f"({t4:.1f}s vs {t1:.1f}s, cold)")
    check(se4 == se1, "four-card SE SAM differs from one card")
    sh, tsh = run(sharded, [files["se"]])
    say(f"[2/3] SE with the SA sharded over 4 cards (all_gather/"
        f"psum_scatter) == one card: {sh == se1} ({tsh:.1f}s, cold)")
    check(sh == se1, "sharded-SA SAM differs from one card")
    pe1, tp1 = run(one, [files["pe1"], files["pe2"]])
    pe4, tp4 = run(four, [files["pe1"], files["pe2"]])
    say(f"[3/3] PE {BATCH} pairs, dp mesh of 4 == one card: {pe4 == pe1} "
        f"({tp4:.1f}s vs {tp1:.1f}s, cold)")
    check(pe4 == pe1, "four-card PE SAM differs from one card")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the four-card path and its one-card "
                        "comparison")
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "tpubwa")):
        fail("run from a checkout of the repository (tpubwa/ is missing)")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    t0 = time.monotonic()
    device = four_cards(args) if args.four else one_card(args)
    say(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
