"""Differential test: flat native extension engine vs the per-read
generator reference.

The flat path (native ext_prepare -> device extend_jobs -> native
ext_finalize, align/flatext.py) must produce exactly the regions of the
generator pipeline (align/region.py extend_read driven by
run_extension_rounds) — same count, order, and every field.  VERDICT r2
task #1 requires this pin before the generator path can stop being the
production route.
"""
import numpy as np


def _mk_aligner(ref_codes, contigs, batch_reads, max_read_len=160):
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex

    idx = FMIndex.build(contigs, ref_codes)
    opt = MemOptions(batch_reads=batch_reads, max_read_len=max_read_len)
    return Aligner(idx, opt)


def _batch(reads, n, max_len):
    from tpubwa.io.fastq import Read, batch_reads

    return next(batch_reads([Read(*r) for r in reads], n, max_len))


def _regs_old(al, batch):
    seed_rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    chains = al.chain_batch(seed_rows, l_rep, batch.lens)
    regs = al.extend_batch_rounds(batch.codes, batch.lens, chains)
    return regs[:batch.n]  # generator path also walks batch-pad rows


def _regs_flat(al, batch):
    from tpubwa.align import flatext

    handle = al.seed_batch_dispatch(batch.codes, batch.lens)
    seed_rows, l_rep = al.seed_batch_finish(handle)
    B = batch.n
    bounds = np.searchsorted(seed_rows[:, 0], np.arange(B + 1))
    skip = (np.asarray(batch.lens) < al.opt.min_seed_len).astype(np.uint8)
    h, jobs, n_jobs = flatext.prepare_jobs(
        al.opt, al.idx.l_pac, al.contig_offsets, seed_rows, bounds, skip,
        batch.lens, l_rep[:B])
    results = flatext.run_waves(al, handle[2], handle[3], jobs, n_jobs)
    return flatext.finalize_regs(h, results, B, n_jobs)


def _assert_equal_regs(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"read {b}: {len(g)} vs {len(w)} regions"
        for i, (x, y) in enumerate(zip(g, w)):
            assert x == y, f"read {b} region {i}:\n  flat {x}\n  ref  {y}"


def test_flat_matches_generator_random_genome(rng):
    """Random 200kb genome, 300 mutated reads (SE), both strands."""
    from tpubwa.io.fasta import Contig
    from tpubwa.utils.sim import simulate_reads

    ref_len = 200_000
    codes = rng.integers(0, 4, ref_len).astype(np.uint8)
    contigs = [Contig("c1", ref_len, 0)]
    al = _mk_aligner(codes, contigs, batch_reads=300)
    reads = simulate_reads(codes, contigs, 300, length=150, err=0.02,
                           indel=0.002, seed=11)
    batch = _batch(reads, 300, 160)
    _assert_equal_regs(_regs_flat(al, batch), _regs_old(al, batch))


def test_flat_matches_generator_repetitive():
    """Repeat-heavy genome: tandem duplications force many seeds per read,
    exercising the containment-skip replay and chain filtering."""
    from tpubwa.io.fasta import Contig
    from tpubwa.utils.sim import simulate_reads

    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 3000).astype(np.uint8)
    # 12 copies of a 3kb unit with 1% divergence, plus unique flanks
    parts = [rng.integers(0, 4, 5000).astype(np.uint8)]
    for _ in range(12):
        c = unit.copy()
        mut = rng.random(c.size) < 0.01
        c[mut] = (c[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        parts.append(c)
    parts.append(rng.integers(0, 4, 5000).astype(np.uint8))
    codes = np.concatenate(parts)
    contigs = [Contig("rep", codes.size, 0)]
    al = _mk_aligner(codes, contigs, batch_reads=200)
    reads = simulate_reads(codes, contigs, 200, length=150, err=0.01,
                           indel=0.001, seed=12)
    batch = _batch(reads, 200, 160)
    _assert_equal_regs(_regs_flat(al, batch), _regs_old(al, batch))


def test_flat_matches_generator_multicontig_short():
    """Multiple contigs + reads shorter than min_seed_len (skip path) +
    exact reads (no-error fast cases)."""
    from tpubwa.io.fasta import Contig
    from tpubwa.io.fastq import Read, batch_reads

    rng = np.random.default_rng(9)
    l1, l2 = 40_000, 25_000
    codes = rng.integers(0, 4, l1 + l2).astype(np.uint8)
    contigs = [Contig("a", l1, 0), Contig("b", l2, l1)]
    al = _mk_aligner(codes, contigs, batch_reads=64)
    from tpubwa.utils.dna import decode

    reads = []
    for i in range(60):
        p = int(rng.integers(0, l1 + l2 - 120))
        reads.append((f"r{i}", decode(codes[p:p + 120]), "I" * 120))
    reads.append(("tiny", "ACGTACGT", "IIIIIIII"))  # < min_seed_len
    batch = next(batch_reads([Read(*r) for r in reads], 64, 160))
    _assert_equal_regs(_regs_flat(al, batch), _regs_old(al, batch))


def test_run_waves_split_matches_fused():
    """The split left/right wave streams (independent depth sorting,
    score0 relayed through the host) must reproduce the fused
    single-program path exactly, at a job count that exercises the
    split path (> 512)."""
    import jax.numpy as jnp

    from tpubwa.align import flatext
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa.utils import sim
    from tpubwa.utils.gensim import repeat_genome

    rng = np.random.default_rng(77)
    codes = repeat_genome(rng, 80_000)
    contigs = [Contig("c1", 80_000, 0)]
    idx = FMIndex.build(contigs, codes)
    al = Aligner(idx, MemOptions(batch_reads=256, max_read_len=160))
    reads = [Read(*r) for r in sim.simulate_reads(
        codes, contigs, 256, length=150, err=0.02, indel=0.003, seed=2)]
    batch = next(batch_reads(reads, 256, 160))
    rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    B = batch.n
    bounds = np.searchsorted(rows[:, 0], np.arange(B + 1))
    skip = (np.asarray(batch.lens) < al.opt.min_seed_len).astype(np.uint8)
    prep = flatext.prepare_jobs(al.opt, idx.l_pac, al.contig_offsets,
                                rows, bounds, skip, batch.lens, l_rep[:B])
    assert prep is not None
    handle, jobs, n_jobs = prep
    assert n_jobs > 512, f"fixture too small to exercise the split path" \
        f" ({n_jobs} jobs)"
    codes_dev = jnp.asarray(np.asarray(batch.codes, np.int32))
    lens_dev = jnp.asarray(np.asarray(batch.lens, np.int32))
    got = flatext.run_waves(al, codes_dev, lens_dev, jobs, n_jobs,
                            lens_host=batch.lens)
    want = flatext._run_waves_fused(al, codes_dev, lens_dev, jobs, n_jobs)
    np.testing.assert_array_equal(got, want)


def test_phased_matches_full():
    """Phased extension rounds (ext_phase1/ext_missing: bwa's sequential
    seed-skip recovered for batched waves) produce byte-identical final
    regions to running every speculative job."""
    import jax.numpy as jnp

    from tpubwa.align import flatext
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa.utils import sim
    from tpubwa.utils.gensim import repeat_genome

    rng = np.random.default_rng(123)
    codes = repeat_genome(rng, 90_000)
    contigs = [Contig("c1", 90_000, 0)]
    idx = FMIndex.build(contigs, codes)
    al = Aligner(idx, MemOptions(batch_reads=192, max_read_len=160))
    reads = [Read(*r) for r in sim.simulate_reads(
        codes, contigs, 192, length=150, err=0.015, indel=0.002, seed=8)]
    batch = next(batch_reads(reads, 192, 160))
    rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    B = batch.n
    bounds = np.searchsorted(rows[:, 0], np.arange(B + 1))
    skip = (np.asarray(batch.lens) < al.opt.min_seed_len).astype(np.uint8)
    codes_dev = jnp.asarray(np.asarray(batch.codes, np.int32))
    lens_dev = jnp.asarray(np.asarray(batch.lens, np.int32))

    def go(phased):
        prep = flatext.prepare_jobs(al.opt, idx.l_pac, al.contig_offsets,
                                    rows, bounds, skip, batch.lens,
                                    l_rep[:B])
        handle, jobs, n_jobs = prep
        if phased:
            res = flatext.run_phased(al, codes_dev, lens_dev, handle,
                                     jobs, n_jobs, lens_host=batch.lens)
            njobs_run = int((res != 0).any(axis=1).sum())
        else:
            res = flatext.run_waves(al, codes_dev, lens_dev, jobs, n_jobs,
                                    lens_host=batch.lens)
            njobs_run = n_jobs
        fields, fb = flatext.finalize_fields(handle, res, B, n_jobs)
        return {k: v[: fb[-1]] for k, v in fields.items()}, fb, \
            n_jobs, njobs_run

    f_full, b_full, n_jobs, _ = go(False)
    f_ph, b_ph, _, n_run = go(True)
    np.testing.assert_array_equal(b_full, b_ph)
    for k in f_full:
        np.testing.assert_array_equal(f_full[k], f_ph[k], err_msg=k)
    # the phased path must actually SKIP a meaningful share of jobs on
    # this repeat fixture
    assert n_run < n_jobs, (n_run, n_jobs)
