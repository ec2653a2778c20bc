"""Serve the 1.2 Gbp WIDE index (>=2^31 text rows) on one card via the
sampled SA (--sa-shift).

Device footprint at shift=5, computed from array sizes: cp 2.4 GB + rank
blocks 1.2 GB + samples 0.6 GB + pac 0.3 GB ~= 4.5 GB, against 19.2 GB for
the full int64 SA.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
fa = os.path.join(REPO, ".bench", "ref_1200000000_big.fa")
fq = os.path.join(REPO, ".bench", "reads_big_20000.fq")
N_READS = int(os.environ.get("N", "20000"))
SHIFT = int(os.environ.get("SHIFT", "5"))

from tpubwa.utils.cache import enable_compile_cache

enable_compile_cache()

if not os.path.exists(fq):
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim

    t0 = time.monotonic()
    contigs, codes, _ = read_fasta(fa)
    reads = sim.simulate_reads(codes, contigs, N_READS, length=150,
                               err=0.01, seed=17)
    sim.write_fastq(fq, reads)
    del codes
    print(f"[big] reads simulated in {time.monotonic()-t0:.0f}s",
          flush=True)

from tpubwa.align.pipeline import Aligner, run_se_pipeline
from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex


class NullOut:
    n_bytes = 0
    n_records = 0

    def write(self, s):
        self.n_bytes += len(s)
        self.n_records += s.count("\n")
        return len(s)


rec = {"ref_len": 1_200_000_000, "sa_shift": SHIFT, "n_reads": N_READS}
t0 = time.monotonic()
idx = FMIndex.load(fa)
rec["index_load_s"] = round(time.monotonic() - t0, 1)
t0 = time.monotonic()
al = Aligner(idx, MemOptions.auto(sa_sample_shift=SHIFT))
import jax

jax.block_until_ready(al.di.cp)
if al.ss is not None:
    jax.block_until_ready(al.ss.vals)
rec["device_setup_s"] = round(time.monotonic() - t0, 1)
print(f"[big] index loaded {rec['index_load_s']}s, device setup "
      f"{rec['device_setup_s']}s", flush=True)

t0 = time.monotonic()
out = NullOut()
run_se_pipeline(al, fq, out)
rec["first_pass_s"] = round(time.monotonic() - t0, 1)
rec["sam_records"] = out.n_records

t0 = time.monotonic()
out2 = NullOut()
run_se_pipeline(al, fq, out2)
rec["warm_pass_s"] = round(time.monotonic() - t0, 1)
rec["reads_per_sec_warm"] = round(N_READS / rec["warm_pass_s"], 1)

# correctness spot-check: fraction of reads mapping back to their
# simulated position (names carry truth: sim_<i>_<rid>_<pos>_<strand>)
import io as _io

sam = _io.StringIO()
h = NullOut()


class Tee:
    def write(self, s):
        sam.write(s)
        return h.write(s)


run_se_pipeline(al, os.path.join(REPO, ".bench", "reads_big_2000.fq")
                if os.path.exists(os.path.join(
                    REPO, ".bench", "reads_big_2000.fq")) else fq, Tee())
ok = tot = 0
for line in sam.getvalue().splitlines():
    if line.startswith("@") or not line.startswith("sim_"):
        continue
    f = line.split("\t")
    parts = f[0].split("_")
    true_pos = int(parts[3])
    tot += 1
    if f[2] != "*" and abs(int(f[3]) - 1 - true_pos) <= 50:
        ok += 1
rec["mapped_near_truth_frac"] = round(ok / max(tot, 1), 4)
with open(os.path.join(REPO, ".bench", "run_big.json"), "w") as f:
    json.dump(rec, f, indent=1)
print(json.dumps(rec), flush=True)
