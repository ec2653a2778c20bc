"""Production pipeline on a device mesh: SAM identity vs single device.

The reference's scale-out tier ran the full binary on N instances in
parallel (test-all-graviton-gcc14.sh, WEEK2_COMPLETE_SUCCESS.md:244-258);
here the full Aligner runs with reads sharded over the 8-virtual-CPU "dp"
mesh (conftest forces xla_force_host_platform_device_count=8) and must
produce byte-identical SAM.
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def fixture():
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa.utils.sim import simulate_reads

    rng = np.random.default_rng(11)
    ref_len = 12000
    codes = rng.integers(0, 4, ref_len).astype(np.uint8)
    contigs = [Contig("m1", ref_len, 0)]
    idx = FMIndex.build(contigs, codes)
    reads = [Read(*r) for r in simulate_reads(codes, contigs, 50, length=100,
                                              err=0.02, indel=0.002, seed=6)]
    opt = MemOptions(batch_reads=64, max_read_len=112)
    batch = next(batch_reads(reads, 64, opt.max_read_len))
    return idx, opt, batch


def test_mesh_production_sam_identity(fixture):
    import jax

    from tpubwa.align.pipeline import Aligner
    from tpubwa.parallel.mesh import make_mesh

    idx, opt, batch = fixture
    try:
        n_cpu = len(jax.devices("cpu"))
    except RuntimeError:
        n_cpu = 0
    if max(len(jax.devices()), n_cpu) < 4:
        pytest.skip("needs >=4 (virtual) devices")

    base = Aligner(idx, opt)
    want = [r.line() for rl in base.align_se_batch(batch, 0) for r in rl]
    assert want, "fixture produced no alignments"

    mesh = make_mesh(4)
    al = Aligner(idx, opt, mesh=mesh)
    got = [r.line() for rl in al.align_se_batch(batch, 0) for r in rl]
    assert got == want


def test_mesh_preset_plumbing(fixture):
    """MemOptions.mesh_shape reaches the Aligner (dead-config check: it was
    once never read)."""
    import jax

    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions

    idx, _, batch = fixture
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 (virtual) devices")
    opt = MemOptions(batch_reads=64, max_read_len=112, mesh_shape=(4,))
    al = Aligner(idx, opt)
    assert al.mesh is not None and al.mesh.devices.size == 4
    recs = al.align_se_batch(batch, 0)
    assert sum(len(r) for r in recs) >= batch.n - 2
