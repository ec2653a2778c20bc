"""Chain -> alignment regions via batched seed extension.

Semantics of bwa-mem's mem_chain2aln (reference call stack SURVEY.md §3.1
worker_aln → mem_chain2aln_across_reads_V2 → BandedPairWiseSW).  The batched
redesign: each read is a generator-coroutine that walks its chains/seeds
(score-descending, with bwa's containment skip tests) and *yields* one
whole-seed job per seed; the driver (run_extension_rounds) batches one
pending job per read per round into a single fused device call
(extend_seed_batch = left + right extension + band-doubling retries) —
the reference's "one SIMD lane = one extension pair" SoA batching,
re-expressed as lockstep rounds over the read batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from tpubwa.align.chain import Chain
from tpubwa.config import MemOptions
from tpubwa.ops.extend_ref import ExtendResult


@dataclasses.dataclass
class AlnReg:
    """Alignment region (bwa mem_alnreg_t)."""

    rb: int = 0           # [rb, re): reference in 2*l_pac coords
    re: int = 0
    qb: int = 0           # [qb, qe): query
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    frac_rep: float = 0.0
    hash: int = 0


@dataclasses.dataclass
class SeedExtJob:
    """One whole-seed extension: left (reversed) + right halves, fused into
    a single device call (ops.extend.extend_seed_batch)."""

    q_l: np.ndarray     # left query, already reversed; may be empty
    t_l: np.ndarray
    q_r: np.ndarray     # right query; may be empty
    t_r: np.ndarray
    h0: int             # seed_len * match score


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(max(l_del, l_ins), 1)
    return min(l, opt.w * 2)


def extend_read(opt: MemOptions, l_pac: int,
                fetch_ref: Callable[[int, int], np.ndarray],
                l_query: int, query: np.ndarray,
                chains: list[Chain]) -> Iterator[ExtJob]:
    """Generator: yields ExtJob, expects ExtendResult sent back; its return
    value (StopIteration.value) is the list[AlnReg] for the read."""
    regs: list[AlnReg] = []
    for c in chains:
        if not c.seeds:
            continue
        # reference window for the whole chain
        rmax0, rmax1 = l_pac * 2, 0
        for t in c.seeds:
            b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
            e = t.rbeg + t.len + (l_query - t.qbeg - t.len) \
                + cal_max_gap(opt, l_query - t.qbeg - t.len)
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, l_pac * 2)
        if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick a side
            if c.seeds[0].rbeg < l_pac:
                rmax1 = l_pac
            else:
                rmax0 = l_pac
        rseq = fetch_ref(rmax0, rmax1)

        # seeds by (score, index) ascending, visited in descending order
        srt = sorted(range(len(c.seeds)),
                     key=lambda i: (c.seeds[i].score, i))
        dropped = [False] * len(c.seeds)
        for k in reversed(range(len(srt))):
            s = c.seeds[srt[k]]
            # --- containment skip test (vs regions computed so far) ---
            contained = False
            for p in regs:
                if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                        or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                    continue
                if s.len - p.seedlen0 > 0.1 * l_query:
                    continue
                qd = s.qbeg - p.qb
                rd = s.rbeg - p.rb
                max_gap = cal_max_gap(opt, min(qd, rd))
                ww = min(max_gap, p.w)
                if qd - rd < ww and rd - qd < ww:
                    contained = True
                    break
                qd = p.qe - (s.qbeg + s.len)
                rd = p.re - (s.rbeg + s.len)
                max_gap = cal_max_gap(opt, min(qd, rd))
                ww = min(max_gap, p.w)
                if qd - rd < ww and rd - qd < ww:
                    contained = True
                    break
            if contained:
                # confirm no overlapping major seed suggests a different aln
                diff = False
                for i2 in range(k + 1, len(srt)):
                    if dropped[srt[i2]]:
                        continue
                    t = c.seeds[srt[i2]]
                    if t.len < s.len * 0.95:
                        continue
                    if (s.qbeg <= t.qbeg
                            and s.qbeg + s.len - t.qbeg >= s.len >> 2
                            and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                        diff = True
                        break
                    if (t.qbeg <= s.qbeg
                            and t.qbeg + t.len - s.qbeg >= s.len >> 2
                            and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                        diff = True
                        break
                if not diff:
                    dropped[srt[k]] = True
                    continue

            a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                       frac_rep=c.frac_rep, seedlen0=s.len)

            has_left = s.qbeg > 0
            has_right = s.qbeg + s.len != l_query
            qe = s.qbeg + s.len
            re0 = s.rbeg + s.len - rmax0
            empty = query[:0]
            res = yield SeedExtJob(
                q_l=(query[: s.qbeg][::-1].copy() if has_left else empty),
                t_l=(rseq[: s.rbeg - rmax0][::-1].copy() if has_left
                     else empty),
                q_r=(query[qe:l_query] if has_right else empty),
                t_r=(rseq[re0:] if has_right else empty),
                h0=s.len * opt.a)
            left, right, aw0, aw1 = res

            if has_left:
                a.score = left.score
                if (left.gscore <= 0
                        or left.gscore <= a.score - opt.pen_clip5):
                    a.qb = s.qbeg - left.qle
                    a.rb = s.rbeg - left.tle
                    a.truesc = a.score
                else:
                    a.qb = 0
                    a.rb = s.rbeg - left.gtle
                    a.truesc = left.gscore
            else:
                a.score = a.truesc = s.len * opt.a
                a.qb = 0
                a.rb = s.rbeg
                aw0 = opt.w

            if has_right:
                sc0 = a.score
                a.score = right.score
                if (right.gscore <= 0
                        or right.gscore <= a.score - opt.pen_clip3):
                    a.qe = qe + right.qle
                    a.re = rmax0 + re0 + right.tle
                    a.truesc += a.score - sc0
                else:
                    a.qe = l_query
                    a.re = rmax0 + re0 + right.gtle
                    a.truesc += right.gscore - sc0
            else:
                a.qe = l_query
                a.re = s.rbeg + s.len
                aw1 = opt.w

            a.seedcov = 0
            for t in c.seeds:
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                        and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                    a.seedcov += t.len
            a.w = max(aw0, aw1)
            regs.append(a)
    return regs


def run_extension_rounds(gens: list[Iterator[SeedExtJob]], opt: MemOptions,
                         mat: np.ndarray, extend_seed_fn,
                         q_pad: int = 192, t_pad: int = 768, put=None,
                         ) -> list[list[AlnReg]]:
    """Drive per-read extension generators in lockstep rounds; one pending
    whole-seed job per read per round, all jobs fused into one device call
    (left + right + band retries — extend_seed_batch).  Live lanes are
    compacted into power-of-two batch buckets so late rounds with few
    surviving reads stay cheap.  `put` maps a host array to device (sharded
    along the lane axis on a mesh)."""
    import jax.numpy as jnp

    if put is None:
        put = jnp.asarray
    n = len(gens)
    results: list[list[AlnReg] | None] = [None] * n
    pending: list[SeedExtJob | None] = [None] * n
    live = set()
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
            live.add(i)
        except StopIteration as e:
            results[i] = e.value or []

    mat_j = put(mat)
    while live:
        idxs = sorted(live)
        nb = len(idxs)
        B = 64
        while B < nb:
            B <<= 1
        t_max = max(max(min(len(pending[i].t_l), t_pad),
                        min(len(pending[i].t_r), t_pad)) for i in idxs)
        t_b = 256 if t_max <= 256 else t_pad
        q_l = np.full((B, q_pad), 4, np.int32)
        t_l = np.full((B, t_b), 4, np.int32)
        q_r = np.full((B, q_pad), 4, np.int32)
        t_r = np.full((B, t_b), 4, np.int32)
        qlen_l = np.zeros(B, np.int32)
        tlen_l = np.zeros(B, np.int32)
        qlen_r = np.zeros(B, np.int32)
        tlen_r = np.zeros(B, np.int32)
        h0 = np.ones(B, np.int32)
        for r, i in enumerate(idxs):
            job = pending[i]
            nql = min(len(job.q_l), q_pad)
            ntl = min(len(job.t_l), t_b)
            nqr = min(len(job.q_r), q_pad)
            ntr = min(len(job.t_r), t_b)
            q_l[r, :nql] = job.q_l[:nql]
            t_l[r, :ntl] = job.t_l[:ntl]
            q_r[r, :nqr] = job.q_r[:nqr]
            t_r[r, :ntr] = job.t_r[:ntr]
            qlen_l[r] = nql
            tlen_l[r] = ntl
            qlen_r[r] = nqr
            tlen_r[r] = ntr
            h0[r] = max(job.h0, 1)
        w0 = np.full(B, opt.w, np.int32)
        pen5 = np.full(B, opt.pen_clip5, np.int32)
        pen3 = np.full(B, opt.pen_clip3, np.int32)
        out = extend_seed_fn(
            put(q_l), put(qlen_l), put(t_l),
            put(tlen_l), put(q_r), put(qlen_r),
            put(t_r), put(tlen_r), mat_j, put(w0),
            put(h0), put(pen5), put(pen3),
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
        # one stacked download (device->host bandwidth is the bottleneck)
        packed = np.asarray(jnp.stack(
            list(out.left) + list(out.right) + [out.aw0, out.aw1]))
        for r, i in enumerate(idxs):
            left = ExtendResult(*(int(packed[f, r]) for f in range(6)))
            right = ExtendResult(*(int(packed[6 + f, r]) for f in range(6)))
            res = (left, right, int(packed[12, r]), int(packed[13, r]))
            try:
                pending[i] = gens[i].send(res)
            except StopIteration as e:
                results[i] = e.value or []
                live.discard(i)
    return results
