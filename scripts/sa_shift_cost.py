"""Measure the sampled-SA seeding-cost delta at shift k in {0, 4, 8} on
the bench fixture: same reads, same index, full
seeding phase (SMEM+SAL wall) under full SA vs sampled SA."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import _ensure_fixture  # noqa: E402
from tpubwa.align.pipeline import Aligner  # noqa: E402
from tpubwa.config import MemOptions  # noqa: E402
from tpubwa.index.fmindex import FMIndex  # noqa: E402
from tpubwa.io.fastq import stream_batches  # noqa: E402
from tpubwa.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

ref_fa, fq1, _ = _ensure_fixture(4.6, 20000, False)
idx = FMIndex.load(ref_fa)

batches = list(stream_batches(fq1, 8192, 320))

for shift in (0, 4, 8):
    opt = MemOptions.auto()
    opt.sa_sample_shift = shift
    al = Aligner(idx, opt)
    # warm (compile + cache)
    al.seed_batch(batches[0].codes, batches[0].lens)
    best = 1e9
    for _ in range(3):
        t0 = time.monotonic()
        for b in batches:
            al.seed_batch(b.codes, b.lens)
        best = min(best, time.monotonic() - t0)
    n = sum(b.n for b in batches)
    print(f"shift={shift}: seeding {best*1e3:7.1f} ms for {n} reads "
          f"({best/n*1e6:.1f} us/read)", flush=True)
