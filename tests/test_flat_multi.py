"""Flat multi-region SE path (columnar dedup/mark_primary + XS/XA) vs the
generator path: byte parity on a repeat-structured genome.

The chr21-scale benchmark exposed that repeat genomes make nearly every
read multi-region (segmental duplications -> several surviving regions),
so the flat path must carry the single-primary fast case: primary record
with XS:i:<sub> and XA:Z alternates, exact mark_primary/gen_xa
semantics.  This is the test fixture the reference project's docs demand
(SVE_OPTIMIZATION_FINDINGS.md: random references silently skip phases)."""
import numpy as np
import pytest

from tpubwa.align.pipeline import Aligner
from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.io.fastq import Read, batch_reads
from tpubwa.utils import sim


def _repeat_genome(rng, n_seg=4, seg_len=12000, div=0.02):
    base = rng.integers(0, 4, seg_len).astype(np.uint8)
    segs = []
    for _ in range(n_seg):
        seg = base.copy()
        mut = rng.random(seg_len) < div
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        segs.append(seg)
    return np.concatenate(segs)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(29)
    codes = _repeat_genome(rng)
    contigs = [Contig("c1", codes.size, 0)]
    idx = FMIndex.build(contigs, codes)
    al = Aligner(idx, MemOptions(batch_reads=96, max_read_len=160))
    reads = sim.simulate_reads(codes, contigs, 96, length=125, err=0.015,
                               indel=0.002, seed=41)
    b = next(batch_reads([Read(n, s, q) for n, s, q in reads], 96, 160))
    return al, b


def _gen_text(al, batch, rid0):
    """Force the generator path for every read."""
    from tpubwa.align import finalize
    from tpubwa.align.flatsam import _alnregs_for
    from tpubwa.align.pipeline import Aligner  # noqa: F401
    from tpubwa.utils.rounds import drive_rounds

    fields, bounds = al._regions_flat(batch)
    gens = [
        finalize.se_records_g(
            al.opt, al.idx, batch.names[i], batch.seqs[i], batch.quals[i],
            batch.codes[i, : batch.lens[i]],
            _alnregs_for(fields, bounds, i), rid0 + i)
        for i in range(batch.n)
    ]
    out = []
    for recs in drive_rounds(gens, al.ga_exec):
        out.append("".join(r.line() + "\n" for r in recs))
    return "".join(out)


def test_multi_region_byte_parity(setup):
    al, b = setup
    flat_text = al.align_se_text(b, 0)
    gen_text = _gen_text(al, b, 0)
    if flat_text != gen_text:
        fl = flat_text.splitlines()
        gl = gen_text.splitlines()
        for x, y in zip(fl, gl):
            assert x == y, f"\nFLAT: {x}\nGEN : {y}"
        assert len(fl) == len(gl)
    # the repeat genome must actually produce XS>0 and XA tags
    assert "XA:Z:" in flat_text
    xs_vals = [int(f.split("XS:i:")[1].split("\t")[0].split("\n")[0])
               for f in flat_text.splitlines() if "XS:i:" in f]
    assert any(v > 0 for v in xs_vals)


def test_multi_region_three_batches(setup):
    """Same through the pipeline driver (read_id offsets affect the
    mark_primary hash tie-breaks — they must match per batch)."""
    al, b = setup
    t1 = al.align_se_text(b, 1234)
    t2 = _gen_text(al, b, 1234)
    assert t1 == t2
