"""Build a >=2^31 ("wide") index from a realistic 1.2 Gbp synthetic genome
and record build time + peak RSS (into .bench/build_big.json).

N = 2 * 1.2e9 = 2.4e9 > 2^31, so this build exercises, for real:
- int64-native SA-IS at Gbp scale (native/sais.cpp)
- cp_hi high-word checkpoint construction (index/fmindex.py)
- 5-byte split SA storage
Reference context: [ref] PHASE4_FINAL_SUMMARY.md:296-309 (GRCh38 plan).

Usage: python scripts/build_big.py [ref_len_bp]   (default 1.2e9)
Writes fixture + index under .bench/ and a BUILD_BIG.json record.
"""
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpubwa.index.fmindex import FMIndex
from tpubwa.utils import gensim

ref_len = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_200_000_000
d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".bench")
os.makedirs(d, exist_ok=True)
fa = os.path.join(d, f"ref_{ref_len}_big.fa")
rec = {"ref_len": ref_len, "n_text": 2 * ref_len}

if not os.path.exists(fa):
    t0 = time.monotonic()
    rng = np.random.default_rng(1234)
    codes, n_mask = gensim.realistic_genome(rng, ref_len)
    rec["gen_s"] = round(time.monotonic() - t0, 1)
    t0 = time.monotonic()
    gensim.write_fasta(fa, codes, n_mask, name="bigsynth")
    rec["write_s"] = round(time.monotonic() - t0, 1)
    del codes, n_mask
    print(f"[big] fasta written: gen {rec.get('gen_s')}s "
          f"write {rec.get('write_s')}s", flush=True)

if not FMIndex.exists(fa):
    t0 = time.monotonic()
    idx = FMIndex.from_fasta(fa)
    rec["index_build_s"] = round(time.monotonic() - t0, 1)
    t0 = time.monotonic()
    idx.save(fa)
    rec["save_s"] = round(time.monotonic() - t0, 1)
    rec["wide"] = idx.seq_len + 1 >= 1 << 31
    rec["seq_len"] = idx.seq_len
    rec["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)
    print(f"[big] index built in {rec['index_build_s']}s, "
          f"peak RSS {rec['peak_rss_gb']} GB, wide={rec['wide']}", flush=True)

rec["npz_gb"] = round(os.path.getsize(fa + ".tpubwa.npz") / 1e9, 2) \
    if os.path.exists(fa + ".tpubwa.npz") else None
with open(os.path.join(d, "build_big.json"), "w") as f:
    json.dump(rec, f, indent=1)
print(json.dumps(rec), flush=True)
