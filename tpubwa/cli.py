"""Command-line interface: ``tpu-bwa index|mem|version``.

Mirrors the reference CLI surface (SURVEY.md §0):
  bwa-mem2 index <ref.fa>
  bwa-mem2 mem [-t N] [-k minSeedLen] <ref.fa> r1.fq [r2.fq] > out.sam
  bwa-mem2 version
(reference: [src] src/main.cpp subcommands; README.md:56-64)
"""
from __future__ import annotations

import argparse
import sys
import time

import tpubwa
from tpubwa.config import PLATFORMS


def cmd_index(args) -> int:
    import os

    from tpubwa.index.fmindex import FMIndex

    if not os.path.exists(args.ref):
        print(f"tpu-bwa index: no such file: {args.ref}", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    print(f"[tpu-bwa] building FM-index for {args.ref}", file=sys.stderr)
    idx = FMIndex.from_fasta(args.ref)
    idx.save(args.ref)
    print(
        f"[tpu-bwa] index built: l_pac={idx.l_pac} seq_len={idx.seq_len} "
        f"contigs={len(idx.contigs)} in {time.monotonic()-t0:.2f}s",
        file=sys.stderr)
    return 0


def cmd_mem(args) -> int:
    import os

    from tpubwa.align.pipeline import align_fastq

    for f in [args.ref, args.reads1] + ([args.reads2] if args.reads2 else []):
        if not os.path.exists(f):
            print(f"tpu-bwa mem: no such file: {f}", file=sys.stderr)
            return 1
    shard = None
    if args.hosts:
        if not args.chunks:
            print("tpu-bwa mem: --hosts requires --chunks DIR",
                  file=sys.stderr)
            return 1
        if not (0 <= args.host_id < args.hosts):
            print("tpu-bwa mem: --host-id must be in [0, --hosts)",
                  file=sys.stderr)
            return 1
        shard = (args.host_id, args.hosts)
    if args.profile:
        # device trace (SURVEY.md §5 "Tracing / profiling": the reference
        # prescribed perf record recipes; here jax.profiler captures the
        # XLA timeline viewable in xprof/tensorboard)
        import jax

        jax.profiler.start_trace(args.profile)
    try:
        return align_fastq(
            ref=args.ref,
            fq1=args.reads1,
            fq2=args.reads2,
            out=sys.stdout,
            min_seed_len=args.k,
            threads=args.t,
            batch_reads=args.batch,
            preset=args.preset,
            chunk_dir=args.chunks,
            sa_sample_shift=args.sa_shift,
            cmdline=" ".join(sys.argv),
            shard=shard,
        )
    except ValueError as e:
        print(f"tpu-bwa mem: {e}", file=sys.stderr)
        return 1
    finally:
        if args.profile:
            import jax

            jax.profiler.stop_trace()
            print(f"[tpu-bwa] device trace written to {args.profile}",
                  file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    from tpubwa.utils.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(
        prog="tpu-bwa",
        description="short-read aligner (BWA-MEM semantics) for GPUs, "
                    "in JAX")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build FM-index for a FASTA reference")
    pi.add_argument("ref")
    pi.set_defaults(fn=cmd_index)

    pm = sub.add_parser("mem", help="align FASTQ reads, write SAM to stdout")
    pm.add_argument("-t", type=int, default=1, help="host worker threads")
    pm.add_argument("-k", type=int, default=19, help="minimum seed length")
    pm.add_argument("--batch", type=int, default=None,
                    help="reads per device batch")
    pm.add_argument("--chunks", default=None, metavar="DIR",
                    help="persist each batch's SAM as an idempotent chunk "
                         "file in DIR; re-running resumes from completed "
                         "chunks (restartable output)")
    pm.add_argument("--preset", default=None, choices=PLATFORMS,
                    help="batch size + device mesh of this platform's "
                         "preset instead of the visible devices' own "
                         "(gpu: 8192 reads per card, reads data-parallel "
                         "over all cards; cpu: 256 reads)")
    pm.add_argument("--sa-shift", type=int, default=0, metavar="S",
                    help="sampled-SA serving: keep 1/2^S of the suffix "
                         "array on device and LF-walk the rest (exact "
                         "results; the single-card mode for genomes "
                         "whose full SA exceeds device memory)")
    pm.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace into DIR")
    pm.add_argument("--hosts", type=int, default=None, metavar="N",
                    help="multi-host scale-out: total number of host "
                         "processes; each aligns its share of the read "
                         "batches into the shared --chunks DIR "
                         "(cat DIR/chunk_*.sam reproduces the single-"
                         "host SAM body).  One process per card: on a "
                         "shared machine give each its own "
                         "CUDA_VISIBLE_DEVICES")
    pm.add_argument("--host-id", type=int, default=0, metavar="H",
                    help="this process's id in [0, --hosts)")
    pm.add_argument("ref")
    pm.add_argument("reads1")
    pm.add_argument("reads2", nargs="?", default=None)
    pm.set_defaults(fn=cmd_mem)

    pv = sub.add_parser("version")
    pv.set_defaults(fn=lambda a: (print(tpubwa.__version__), 0)[1])

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
