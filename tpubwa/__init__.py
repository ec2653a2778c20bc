"""tpubwa — a short-read DNA aligner for GPUs, in JAX.

Brand-new framework with the capabilities of BWA-MEM2 (reference project:
scttfrdmn/bwa-mem2-arm, surveyed in SURVEY.md), designed for batched
device execution:

- ``index``: packs a reference genome into device-resident FM-index tensors
  (2-bit packed reference, checkpointed occ table, full suffix array).
- ``mem``: aligns short reads end-to-end — SMEM seeding via batched FM-index
  backward search (gather-heavy XLA), seed chaining, banded affine-gap
  Smith-Waterman seed extension (a CUDA kernel, one thread per job),
  paired-end scoring + mate rescue, SAM emission.

Layout:
  tpubwa.index    — index build + on-disk/device layout    (ref: FMI_search.{h,cpp} index side)
  tpubwa.ops      — device compute: FM search, SMEM, SW DP (ref: FMI_search.cpp, bandedSWA*.cpp, ksw.cpp)
  tpubwa.align    — pipeline: seeding/chaining/extension/pairing/SAM (ref: bwamem.cpp, bwamem_pair.cpp)
  tpubwa.io       — FASTA/FASTQ/SAM host IO                (ref: fastmap.cpp)
  tpubwa.parallel — mesh/sharding + host<->device streaming (ref: kthread*.cpp, runsimd_arm.cpp)
  tpubwa.utils    — config, timers, DNA utils, simulator
"""

__version__ = "0.1.0"
