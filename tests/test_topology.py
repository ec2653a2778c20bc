"""Device selection (reference analog: the runsimd_arm dispatcher's CPU
probe — here jax.devices() picks the batch and mesh, and what it cannot
serve is an error, not a fallback)."""
import io

import numpy as np
import pytest

from tpubwa.config import MemOptions


@pytest.mark.parametrize("n", [1, 4])
def test_gpu_preset(n):
    """8192 reads per card; a ("dp",) mesh over the cards when n > 1."""
    opt = MemOptions.preset("gpu", n, min_seed_len=21)
    assert opt.batch_reads == 8192 * n
    assert opt.mesh_shape == ((n,) if n > 1 else ())
    assert opt.pad_tail_full and opt.min_seed_len == 21


def test_cpu_preset_and_auto():
    opt = MemOptions.preset("cpu", 8)
    assert (opt.batch_reads, opt.mesh_shape) == (256, ())
    assert MemOptions.auto().batch_reads == 256  # CPU platform here


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no preset"):
        MemOptions.preset(platform, 1)


def test_make_mesh_too_few_devices_raises():
    import jax

    from tpubwa.parallel.mesh import make_mesh

    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="only"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="only 1"):
        make_mesh(4, devices=jax.devices()[:1])


def test_align_fastq_no_preset_auto(tmp_path):
    """`tpu-bwa mem` with no --preset picks a preset from the visible
    devices and completes (CPU platform here -> the cpu preset)."""
    from tpubwa.align.pipeline import align_fastq
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 8000).astype(np.uint8)
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + decode(codes) + "\n")
    FMIndex.build([Contig("c1", 8000, 0)], codes).save(ref)
    reads = sim.simulate_reads(codes, [Contig("c1", 8000, 0)], 8,
                               length=100, err=0.01, seed=4)
    fq = str(tmp_path / "r.fq")
    sim.write_fastq(fq, reads)
    out = io.StringIO()
    rc = align_fastq(ref, fq, None, out)
    assert rc == 0
    lines = [ln for ln in out.getvalue().splitlines()
             if not ln.startswith("@")]
    assert len(lines) == 8
