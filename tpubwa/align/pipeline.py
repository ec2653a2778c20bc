"""End-to-end alignment pipeline: FASTQ -> device seeding/extension -> host
chaining/finalization -> SAM.

Reference analog: fastmap.cpp's 3-stage kt_pipeline (SURVEY.md §3.1).  The
device shape: per read-batch, the hot phases run as fixed-shape device calls
(SMEM seeding, SA expansion, lockstep extension rounds); chaining and SAM
construction run on host.  Phase timers mirror the reference's breakdown
(SMEM / SAL / CHAIN / BSW / SAM / IO — SURVEY.md §5).
"""
from __future__ import annotations

import sys

import numpy as np

import tpubwa
from tpubwa.align import chain as chainmod
from tpubwa.align import finalize
from tpubwa.align.region import extend_read, run_extension_rounds
from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fastq import batch_reads  # noqa: F401 (re-export)
from tpubwa.io.sam import sam_header
from tpubwa.utils.timers import PhaseTimers


import functools


@functools.lru_cache(maxsize=None)
def _slice_fn(lo: int, hi: int):
    import jax

    return jax.jit(lambda p: p[lo:hi])


def _slice_rows(packed, bucket: int):
    """Device slice of the dense seed-row prefix (one program per pow2
    bucket; dispatched at seeding time so the d2h copy rides the FIFO
    stream directly behind the seeding compute)."""
    return _slice_fn(0, bucket)(packed)


def _slice_rows_tail(packed, lo: int, hi: int):
    return _slice_fn(lo, hi)(packed)


class Aligner:
    """Holds the loaded index (host + device) and aligns read batches.

    With ``opt.mesh_shape`` set (or an explicit ``mesh``), the device phases
    (SMEM seeding, seed expansion, extension DP, CIGAR DP) run data-parallel
    over the mesh's "dp" axis — reads sharded across cards, the FM-index
    replicated per device (SURVEY.md §2.2 "instance-level scale-out" mapped
    to jax.sharding).  Host chaining/finalize is unchanged: it sees gathered
    arrays."""

    def __init__(self, idx: FMIndex, opt: MemOptions | None = None,
                 mesh=None):
        import jax
        import jax.numpy as jnp  # noqa: F401

        from tpubwa.align.cigar_batch import GABatchExecutor
        from tpubwa.ops.extend import extend_seed_batch, select_core
        from tpubwa.ops.fm import DeviceIndex
        from tpubwa.ops.seeds import seed_rows
        from tpubwa.ops.smem_chain import collect_smems_chain

        self.idx = idx
        self.opt = opt or MemOptions()
        if idx.seq_len + 1 >= 1 << 31:
            # wide (GRCh38-scale) index: device intervals/SA are int64
            # (ops/fm.py DeviceIndex wide layout) — needs jax x64.
            # PROCESS-GLOBAL side effect (ADVICE r4): x64 changes jax's
            # dtype promotion for everything else in this process and
            # forces recompiles of narrow-index programs — warn when
            # flipping it on behalf of the caller.
            if not jax.config.jax_enable_x64:
                print("[tpu-bwa] note: enabling jax x64 globally for the "
                      "wide (>=2^31) index — affects dtype promotion "
                      "process-wide", file=sys.stderr)
                jax.config.update("jax_enable_x64", True)
        self.mat = self.opt.score_matrix()
        self.contig_offsets = np.array([c.offset for c in idx.contigs],
                                       dtype=np.int64)

        if mesh is None and self.opt.mesh_shape:
            from tpubwa.parallel.mesh import make_mesh

            n_mesh = int(np.prod(self.opt.mesh_shape))
            if n_mesh > 1:
                mesh = make_mesh(n_mesh)
        self.mesh = mesh
        if self.opt.sa_sample_shift and self.opt.shard_sa:
            raise ValueError("sa_sample_shift and shard_sa are exclusive "
                             "SA serving modes")
        if self.opt.shard_sa and mesh is None:
            # ADVICE r4: without this, mesh=None flows into
            # sa_lookup_sharded and crashes opaquely deep inside jit
            raise ValueError("shard_sa requires a device mesh "
                             "(set opt.mesh_shape or pass mesh=)")
        self.ss = None
        if self.opt.sa_sample_shift:
            # sampled-SA serving: ship 1/2^shift of the SA + the rank
            # directory; the full-resolution device SA is never built
            # (ops.fm.build_sampled_sa / sa_lookup_sampled)
            from tpubwa.ops.fm import build_sampled_sa

            wide = idx.seq_len + 1 >= 1 << 31
            self.ss = build_sampled_sa(None, self.opt.sa_sample_shift,
                                       wide, idx=idx)
            self.di = DeviceIndex.from_host(idx, sa_stub=True)
        else:
            self.di = DeviceIndex.from_host(idx)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._dp = NamedSharding(mesh, P("dp"))
            repl = NamedSharding(mesh, P())
            if self.opt.shard_sa:
                # GRCh38 serving mode: the SA does not fit one card —
                # shard it over the mesh (lookups go through
                # ops.fm.sa_lookup_sharded's all_gather/psum_scatter)
                D = mesh.devices.size
                sa_host = np.asarray(self.di.sa)
                pad = (-len(sa_host)) % D
                if pad:
                    sa_host = np.concatenate(
                        [sa_host, np.zeros(pad, sa_host.dtype)])
                sa_dev = jax.device_put(
                    sa_host, NamedSharding(mesh, P("dp")))
                rest = jax.device_put(self.di._replace(sa=self.di.sa[:1]),
                                      repl)
                self.di = rest._replace(sa=sa_dev)
            else:
                self.di = jax.device_put(self.di, repl)
            if self.ss is not None:
                self.ss = jax.device_put(self.ss, repl)
            self._n_shard = mesh.devices.size
        else:
            self._dp = None
            self._n_shard = 1

        self._collect = collect_smems_chain
        self._expand = seed_rows
        self.n_overflow = 0  # reads whose SMEM/seed buffers overflowed
        # reads finalized, and those the flat engine declined to the
        # per-read generator path (align/flatsam.py, align/pair.py)
        self.n_flat_reads = 0
        self.n_declined = 0
        import threading

        self._ovf_lock = threading.Lock()  # -t workers share this Aligner
        self._row_bucket = 4096  # sticky seed-row download size (pow2;
        #                          tracks the previous batch's row count)
        if mesh is not None:
            platform = mesh.devices.flat[0].platform
        else:
            from tpubwa.parallel.mesh import default_device

            platform = default_device().platform
        self.ext_core = select_core(platform, mesh)
        self._extend = functools.partial(extend_seed_batch,
                                         core=self.ext_core)
        self.mat_dev = self._put(self.mat, batch=False)
        self.ga_exec = GABatchExecutor(self.opt, put=self._put)
        self.timers = PhaseTimers()

    def _put(self, arr, batch: bool | None = None):
        """Host array -> device; on a mesh, batch arrays are sharded along
        their leading axis, everything else is replicated.  ``batch=None``
        falls back to the divisibility heuristic (callers that know the
        array's role pass it explicitly — ADVICE r2: a non-batch array
        whose leading dim happens to divide the mesh must not be sharded)."""
        import jax
        import jax.numpy as jnp

        if self._dp is None:
            return jnp.asarray(arr)
        arr = np.asarray(arr)
        if batch is None:
            batch = bool(arr.ndim) and arr.shape[0] % self._n_shard == 0
        if batch and arr.ndim and arr.shape[0] % self._n_shard == 0:
            return jax.device_put(arr, self._dp)
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(arr, NamedSharding(self.mesh, P()))

    # ------------------------------------------------ device seeding ----

    def seed_batch_dispatch(self, codes: np.ndarray, lens: np.ndarray):
        """Dispatch device seeding; returns a handle for seed_batch_finish.

        The dispatch/finish split lets a caller overlap seeding of one
        batch with host work on another; the production drivers get that
        overlap from run_ordered_pool's worker threads instead and call the
        synchronous seed_batch (profiling scripts use the split form)."""
        import jax.numpy as jnp

        opt = self.opt
        ns = self._n_shard
        # pad the batch up to a pow2 bucket (capped at batch_reads): a
        # short tail batch would otherwise recompile every seeding program
        # at its odd shape (pad reads have lens=0 -> their chain lanes are
        # DONE immediately, near-zero device cost)
        B0 = len(lens)
        if opt.pad_tail_full and B0 <= opt.batch_reads:
            # production policy: every batch (incl. the tail) runs at the
            # ONE batch_reads seeding shape — a second shape family is a
            # second cold compile; pad lanes have lens=0 and are DONE
            # immediately (masked device work)
            B_pad = opt.batch_reads
        else:
            B_pad = 64
            while B_pad < B0:
                B_pad <<= 1
            B_pad = min(max(B_pad, B0), max(opt.batch_reads, B0))
        if B0 < B_pad:
            pad = B_pad - B0
            codes = np.concatenate(
                [codes, np.zeros((pad, codes.shape[1]), codes.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        if ns > 1 and len(lens) % ns:  # pad batch to the shard count
            pad = ns - len(lens) % ns
            codes = np.concatenate(
                [codes, np.zeros((pad, codes.shape[1]), codes.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        with self.timers.phase("SMEM"):
            # ship codes as uint8 (values 0..4), a quarter of the int32
            # upload; every device consumer casts to int32 on device
            codes_dev = self._put(np.asarray(codes, np.uint8), batch=True)
            lens_dev = self._put(np.asarray(lens, np.int32), batch=True)
            sm = self._collect(
                self.di, codes_dev, lens_dev,
                min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
                out_cap=opt.max_smems_per_read)
            cs = self._expand(self.di, sm, max_occ=opt.max_occ,
                              per_read_cap=opt.max_seeds_per_read,
                              mesh=self.mesh if opt.shard_sa else None,
                              shard_sa=opt.shard_sa, ss=self.ss,
                              sa_shift=opt.sa_sample_shift)
            ovf = (sm.overflow | cs.overflow).astype(jnp.int32)
            meta_dev = jnp.concatenate([cs.n[None], cs.l_rep, ovf])
            # enqueue the host copies NOW, before any later batch's device
            # work, so a download requested at finish() time does not wait
            # behind the NEXT batch's seeding compute.  The row prefix
            # length isn't known until meta arrives, so download a sticky
            # pow2 bucket (the previous batch's row count, production loads
            # are stable); finish() tops up the rare under-guess with a
            # blocking read.
            bucket = min(self._row_bucket, cs.packed.shape[0])
            rows_dev = _slice_rows(cs.packed, bucket)
            meta_dev.copy_to_host_async()
            rows_dev.copy_to_host_async()
        return cs, meta_dev, codes_dev, lens_dev, rows_dev, bucket

    def seed_batch_finish(self, handle):
        """Block on a dispatched seeding handle; returns
        (seed_rows [n, 4] = (read_id, rbeg, qbeg, len), l_rep [B]).
        Seeds were compacted on device; only the dense prefix downloads."""
        cs, meta_dev = handle[0], handle[1]
        rows_dev, bucket = handle[4], handle[5]
        with self.timers.phase("SAL"):
            meta = np.asarray(meta_dev)
            n = int(meta[0])
            B = (len(meta) - 1) // 2
            l_rep = meta[1:1 + B]
            n_ovf = int(meta[1 + B:].sum())
            if n_ovf:
                # the reference's MAX_SEED_HITS was explicit, logged
                # behavior (PHASE4_WEEK3_SEED_FILTERING.md) — never silent
                with self._ovf_lock:
                    self.n_overflow += n_ovf
                print(f"[tpu-bwa] warning: {n_ovf} read(s) exceeded "
                      "SMEM/seed buffer caps; their seed lists were "
                      "truncated", file=sys.stderr)
            # round the prefix length up to a pow2 to bound the number of
            # distinct slice programs (each distinct length compiles)
            n_pad = 4096
            while n_pad < n:
                n_pad <<= 1
            n_pad = min(n_pad, cs.packed.shape[0])
            if n <= bucket:
                rows = np.asarray(rows_dev)[:n]
            else:  # under-guessed: top up the missing tail (blocking)
                tail = np.asarray(
                    _slice_rows_tail(cs.packed, bucket, n_pad))
                rows = np.concatenate(
                    [np.asarray(rows_dev), tail])[:n]
            self._row_bucket = n_pad
        return rows, l_rep

    def seed_batch(self, codes: np.ndarray, lens: np.ndarray):
        """Synchronous dispatch + finish."""
        return self.seed_batch_finish(self.seed_batch_dispatch(codes, lens))

    # ------------------------------------------------ host chaining ----

    def chain_batch(self, seed_rows: np.ndarray, l_rep: np.ndarray, lens):
        opt = self.opt
        B = len(lens)
        with self.timers.phase("CHAIN"):
            # seed rows are in (read, slot) order: per-read segments
            bounds = np.searchsorted(seed_rows[:, 0], np.arange(B + 1))
            skip = (np.asarray(lens) < opt.min_seed_len).astype(np.uint8)
            cb = chainmod.chain_filter_batch_native(
                opt, self.idx.l_pac, self.contig_offsets, seed_rows,
                bounds, skip)
            return cb.to_lists(B, l_rep, lens)

    # ------------------------------------------------ extension ----

    def extend_batch_rounds(self, codes, lens, chains_per_read):
        opt = self.opt
        with self.timers.phase("BSW"):
            gens = [
                extend_read(opt, self.idx.l_pac, self.idx.fetch_ref,
                            int(lens[b]), codes[b, : lens[b]],
                            chains_per_read[b])
                for b in range(len(chains_per_read))
            ]
            regs = run_extension_rounds(gens, opt, self.mat, self._extend,
                                        put=self._put)
        return regs

    # ------------------------------------------ flat extension path ----

    def _regions_flat(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch via the flat native engine;
        returns (fields, bounds)."""
        from tpubwa.align import flatext

        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        seed_rows, l_rep = self.seed_batch_finish(seed_handle)
        codes_dev, lens_dev = seed_handle[2], seed_handle[3]

        B = batch.n
        with self.timers.phase("CHAIN"):
            bounds = np.searchsorted(seed_rows[:, 0], np.arange(B + 1))
            skip = (np.asarray(batch.lens) < self.opt.min_seed_len
                    ).astype(np.uint8)
            handle, jobs, n_jobs = flatext.prepare_jobs(
                self.opt, self.idx.l_pac, self.contig_offsets, seed_rows,
                bounds, skip, batch.lens, l_rep[:B])
        with self.timers.phase("BSW"):
            results = flatext.run_phased(self, codes_dev, lens_dev,
                                         handle, jobs, n_jobs,
                                         lens_host=batch.lens)
            return flatext.finalize_fields(handle, results, B, n_jobs)

    def regions_batch(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch; returns list[list[AlnReg]].

        The flat chain/extension engine — two native calls + pow2 device
        waves (align/flatext.py); the per-read generator pipeline
        (chain_batch + extend_batch_rounds) gives identical regions and
        stays as its test reference (tests/test_extend_flat.py)."""
        from tpubwa.align.flatsam import _alnregs_for

        fields, fbounds = self._regions_flat(batch, seed_handle=seed_handle)
        return [_alnregs_for(fields, fbounds, b) for b in range(batch.n)]

    # ------------------------------------------------ full batch ----

    def align_se_text(self, batch, read_id0: int, seed_handle=None) -> str:
        """Align a ReadBatch single-end; returns SAM text (the production
        SE path: flat columnar finalize, align/flatsam.py).  Byte-identical
        to align_se_batch's records (tests/test_flatsam.py)."""
        from tpubwa.align import flatsam

        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        flat = self._regions_flat(batch, seed_handle=seed_handle)
        with self.timers.phase("SAM"):
            return flatsam.se_text_batch(self, batch, read_id0, *flat,
                                         codes_dev=seed_handle[2])

    def _se_records_from_regs(self, batch, read_id0: int, regs):
        from tpubwa.utils.rounds import drive_rounds

        with self.timers.phase("SAM"):
            gens = [
                finalize.se_records_g(
                    self.opt, self.idx, batch.names[b], batch.seqs[b],
                    batch.quals[b], batch.codes[b, : batch.lens[b]],
                    regs[b], read_id0 + b)
                for b in range(batch.n)
            ]
            return drive_rounds(gens, self.ga_exec)

    def align_se_batch(self, batch, read_id0: int, seed_handle=None):
        """Align a ReadBatch single-end; returns list[list[SamRecord]].

        SAM finalization drives all reads' generators in lockstep rounds so
        every CIGAR DP fill in the batch runs as bucketed device calls
        (the reference ran scalar ksw_global2 per alignment in worker_sam)."""
        regs = self.regions_batch(batch, seed_handle=seed_handle)
        return self._se_records_from_regs(batch, read_id0, regs)


def align_fastq(ref: str, fq1: str, fq2: str | None, out,
                min_seed_len: int = 19, threads: int = 1,
                batch_reads_n: int | None = None, batch_reads=None,
                preset: str | None = None, chunk_dir: str | None = None,
                cmdline: str = "tpu-bwa mem",
                shard: tuple[int, int] | None = None,
                sa_sample_shift: int = 0) -> int:
    """CLI entry: align FASTQ(s) against an indexed reference, write SAM."""
    import jax

    if not FMIndex.exists(ref):
        print(f"[tpu-bwa] no index for {ref}; run `tpu-bwa index` first",
              file=sys.stderr)
        return 1
    idx = FMIndex.load(ref)
    devs = jax.devices()
    platform = preset or devs[0].platform
    opt = MemOptions.preset(platform, len(devs), min_seed_len=min_seed_len)
    if batch_reads is not None:
        opt.batch_reads = int(batch_reads)
    if sa_sample_shift:
        opt.sa_sample_shift = int(sa_sample_shift)
    aligner = Aligner(idx, opt)
    mesh_txt = (f"mesh {tuple(opt.mesh_shape)}" if opt.mesh_shape
                else "single device")
    print(f"[tpu-bwa] devices: {len(devs)}x {devs[0].platform} "
          f"({devs[0].device_kind}) -> {platform} preset "
          f"(batch {opt.batch_reads}, {mesh_txt})", file=sys.stderr)
    out.write(sam_header(idx.contigs, cmdline, tpubwa.__version__))
    manifest = _run_manifest(ref, fq1, fq2, opt) if chunk_dir else None

    if shard is not None and not chunk_dir:
        raise ValueError("multi-host sharding requires --chunks DIR "
                         "(hosts meet in the shared chunk directory)")
    if fq2 is not None:
        from tpubwa.align.pair import align_pe_fastq

        rc = align_pe_fastq(aligner, fq1, fq2, out, workers=threads,
                            chunk_dir=chunk_dir, manifest=manifest,
                            shard=shard)
        print(engine_report(aligner), file=sys.stderr)
        return rc

    run_se_pipeline(aligner, fq1, out, workers=threads, chunk_dir=chunk_dir,
                    manifest=manifest, shard=shard)
    print(aligner.timers.report(), file=sys.stderr)
    print(engine_report(aligner), file=sys.stderr)
    return 0


def engine_report(aligner: Aligner) -> str:
    """One stderr line: reads finalized by the flat engine and the share
    it declined to the per-read generator path."""
    n, d = aligner.n_flat_reads, aligner.n_declined
    return (f"[tpu-bwa] flat engine: {n} reads finalized, {d} declined to "
            f"the generator path ({d / max(n, 1):.4f})")


def _run_manifest(ref: str, fq1: str, fq2: str | None,
                  opt: MemOptions) -> dict:
    """Identity of an alignment run for --chunks resume validation: the
    inputs (path + size + mtime) and every option that affects chunk
    boundaries or content."""
    import dataclasses
    import os

    def fid(p):
        st = os.stat(p)
        return [os.path.abspath(p), st.st_size, st.st_mtime]

    return {
        "ref": fid(ref),
        "fq1": fid(fq1),
        "fq2": fid(fq2) if fq2 else None,
        "opt": {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(opt).items()},
    }


def _check_chunk_manifest(chunk_dir: str, manifest: dict | None) -> None:
    """Refuse to resume from chunks produced under a different run identity
    (input files, batch size, alignment options): stale chunk files would be
    spliced into the output verbatim and silently corrupt the SAM."""
    import json
    import os

    if manifest is None:
        return
    path = os.path.join(chunk_dir, "manifest.json")
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev != manifest:
            raise RuntimeError(
                f"chunk dir {chunk_dir} was written by a different run "
                f"(manifest mismatch); delete it or point --chunks at a "
                f"fresh directory.\n  existing: {prev}\n  current:  "
                f"{manifest}")
    else:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)


def run_ordered_pool(items, work, out, workers: int, label: str = "reads",
                     chunk_dir: str | None = None,
                     manifest: dict | None = None,
                     shard: tuple[int, int] | None = None) -> int:
    """Generic pipelined driver: a reader thread streams work items,
    ``workers`` threads each process whole items (device calls from all
    workers interleave on the device's stream while host Python of one item
    overlaps device waits of another), and a writer emits results strictly
    in input order so output is deterministic regardless of scheduling.

    Reference analog: fastmap.cpp's kt_pipeline + kt_for workers (SURVEY.md
    §3.1); ``-t`` drives the worker count like the reference's thread flag
    (any requested count is honored — overlap benefit saturates once host
    work hides device waits, exactly like the reference past its core
    count, but the choice is the user's).

    ``items`` yields (payload, n_units); ``work(payload) -> text``.

    With ``chunk_dir`` set, each work item's output is also persisted as an
    idempotent chunk file (atomic tmp+rename); items whose chunk already
    exists are NOT recomputed — re-running an interrupted command resumes
    from the completed chunks (SURVEY.md §5 "Failure detection": per-shard
    restart + idempotent output chunking).  ``manifest`` identifies the run
    (inputs + options); resuming from a chunk dir whose manifest differs is
    an error.

    ``shard=(host_id, n_hosts)`` is the multi-host scale-out mode
    (reference analog: whole-binary-per-instance parallel launches,
    /root/reference/WEEK2_COMPLETE_SUCCESS.md:244-258): this process only
    computes items with global_seq %% n_hosts == host_id, but chunk files
    keep their GLOBAL sequence numbers — when every host has finished
    against the same chunk_dir, concatenating chunk_*.sam in name order
    reproduces the single-host output exactly."""
    import heapq
    import os
    import queue
    import threading

    if chunk_dir:
        os.makedirs(chunk_dir, exist_ok=True)
        _check_chunk_manifest(chunk_dir, manifest)

    def chunk_path(seq: int) -> str:
        return os.path.join(chunk_dir, f"chunk_{seq:06d}.sam")

    workers = max(1, int(workers))
    in_q: "queue.Queue" = queue.Queue(maxsize=workers + 1)
    out_q: "queue.Queue" = queue.Queue(maxsize=workers * 2 + 2)
    err: list[BaseException] = []
    stop = threading.Event()  # set on any worker/reader error
    n_done = 0
    done_lock = threading.Lock()

    def reader():
        try:
            lseq = 0
            for gseq, (payload, n_units) in enumerate(items):
                if stop.is_set():
                    break
                if shard is not None and gseq % shard[1] != shard[0]:
                    continue  # another host's item
                # bounded put that stays responsive to worker errors: if
                # every worker died the queue never drains and a plain
                # put() would deadlock the whole pool (ADVICE r2 #1)
                while True:
                    try:
                        in_q.put((lseq, gseq, payload, n_units),
                                 timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
                lseq += 1
        except BaseException as e:  # propagate to main
            err.append(e)
            stop.set()
        finally:
            for _ in range(workers):
                while True:
                    try:
                        in_q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            # drain so the sentinel fits; workers are dead
                            try:
                                in_q.get_nowait()
                            except queue.Empty:
                                pass

    def worker():
        nonlocal n_done
        while True:
            item = in_q.get()
            if item is None:
                out_q.put(None)
                return
            seq, gseq, payload, n_units = item
            try:
                if chunk_dir and os.path.exists(chunk_path(gseq)):
                    with open(chunk_path(gseq)) as f:  # resume: reuse chunk
                        text = f.read()
                else:
                    text = work(payload)
                    if chunk_dir:
                        tmp = chunk_path(gseq) + ".tmp"
                        with open(tmp, "w") as f:
                            f.write(text)
                        os.replace(tmp, chunk_path(gseq))  # atomic publish
            except BaseException as e:
                err.append(e)
                stop.set()
                out_q.put(None)
                return
            with done_lock:
                n_done += n_units
                print(f"[tpu-bwa] {n_done} {label} processed",
                      file=sys.stderr)
            out_q.put((seq, text))

    def writer():
        heap: list = []
        want = 0
        ended = 0
        while ended < workers:
            item = out_q.get()
            if item is None:
                ended += 1
                continue
            heapq.heappush(heap, item)
            while heap and heap[0][0] == want:
                _, text = heapq.heappop(heap)
                out.write(text)
                want += 1
        while heap:  # error path: drain what completed
            _, text = heapq.heappop(heap)
            out.write(text)

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    ws = [threading.Thread(target=worker, daemon=True)
          for _ in range(workers)]
    rt.start()
    for w in ws:
        w.start()
    wt.start()
    wt.join()
    rt.join()
    for w in ws:
        w.join()
    if err:
        raise err[0]
    return n_done


def run_se_pipeline(aligner: Aligner, fq1: str, out, workers: int = 1,
                    chunk_dir: str | None = None,
                    manifest: dict | None = None,
                    shard: tuple[int, int] | None = None) -> int:
    """SE driver.

    ``workers == 1`` (the default) uses a deterministic single-thread
    software pipeline: batch N+1's device seeding is DISPATCHED before
    batch N's host finalize runs, so the device chews the next batch
    while the host assembles SAM — the dispatch/finish split gives
    kt_pipeline's overlap without a second Python thread (worker threads
    fight over the GIL during the numpy/ctypes host phases; measured
    slower than serial).  ``workers > 1`` keeps the ordered thread pool
    (useful when host work dominates, e.g. generator-heavy workloads)."""
    from tpubwa.io.fastq import stream_batches

    opt = aligner.opt

    def items():
        read_id0 = 0
        for batch in stream_batches(fq1, opt.batch_reads, opt.max_read_len):
            yield (batch, read_id0), batch.n
            read_id0 += batch.n

    def work(payload):
        batch, read_id0 = payload
        return aligner.align_se_text(batch, read_id0)

    if workers <= 1:
        return _run_se_pipelined(aligner, items(), out,
                                 chunk_dir=chunk_dir, manifest=manifest,
                                 shard=shard)
    return run_ordered_pool(items(), work, out, workers,
                            chunk_dir=chunk_dir, manifest=manifest,
                            shard=shard)


def _run_se_pipelined(aligner: Aligner, items, out,
                      chunk_dir: str | None = None,
                      manifest: dict | None = None,
                      shard: tuple[int, int] | None = None) -> int:
    """Single-thread dispatch-ahead SE driver (see run_se_pipeline)."""
    import os

    if chunk_dir:
        os.makedirs(chunk_dir, exist_ok=True)
        _check_chunk_manifest(chunk_dir, manifest)

    def chunk_path(seq: int) -> str:
        return os.path.join(chunk_dir, f"chunk_{seq:06d}.sam")

    n_done = 0
    pend = None  # (gseq, batch, read_id0, seed_handle | None)

    def finish(gseq, batch, read_id0, handle):
        nonlocal n_done
        if handle is None:  # resume: chunk already on disk
            with open(chunk_path(gseq)) as f:
                text = f.read()
        else:
            text = aligner.align_se_text(batch, read_id0,
                                         seed_handle=handle)
            if chunk_dir:
                tmp = chunk_path(gseq) + ".tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, chunk_path(gseq))
        out.write(text)
        n_done += batch.n
        print(f"[tpu-bwa] {n_done} reads processed", file=sys.stderr)

    for gseq, (payload, _n) in enumerate(items):
        if shard is not None and gseq % shard[1] != shard[0]:
            continue
        batch, read_id0 = payload
        if chunk_dir and os.path.exists(chunk_path(gseq)):
            handle = None
        else:
            handle = aligner.seed_batch_dispatch(batch.codes, batch.lens)
        if pend is not None:
            finish(*pend)
        pend = (gseq, batch, read_id0, handle)
    if pend is not None:
        finish(*pend)
    return n_done
