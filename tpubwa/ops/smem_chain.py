"""Chain-structured SMEM collection — one lane per read, bounded depth.

The device seeding engine.  The flat per-start formulation (ops.smem_flat)
re-extends every read position and loses to gather bandwidth; the reference's
sequential walk ([src] FMI_search.cpp bwt_smem1, SURVEY.md §3.1) does the
*minimum* number of occ lookups per read (~2-3x read length) but is a chain
of dependent steps.  On the device the right shape is: keep the minimal-work chain,
give every READ its own lane, and scale throughput with batch size — depth
stays ~2-3L no matter how many reads are in flight, and each step is one
batched occ-checkpoint gather (ops.fm.ext_core) across all lanes.

Round-1 chain per lane (state machine, all lanes step in lockstep):

  FRESH: scan for the next root position (skip Ns / end)
  FWD:   extend [start, i) rightward to maximality -> emit SMEM [start, i)
  BWD:   from the failed append at i, find the longest match ending at i+1
         (prepend leftward); its start is the next left-maximal root, and
         its interval re-enters FWD with no rescan -> every read position
         is consumed O(1) times

Correctness: roots s_0 < s_1 < ... are exactly the left-maximal starts
(E(s) is constant between consecutive roots), so the emitted set equals
{[s, E(s)) : E(s-1) < E(s)} = the SMEM set.  Round 2 runs the same chain
per (read, candidate) lane at occ threshold t through the candidate's
middle; round 3 is a forward-only restart chain (LAST-like seeding).
Semantics are defined by tpubwa.ops.fm_ref; tests assert exact equality.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpubwa.ops.fm import DeviceIndex, ext_core, set_intv
from tpubwa.ops.smem import Smems, _pick_base

I32 = jnp.int32
BIG = jnp.int32(1 << 30)

FRESH, FWD, BWD, DONE = 0, 1, 2, 3

# every chain step is fully masked (DONE lanes are no-ops), so running
# UNROLL steps per while_loop iteration amortizes the loop's per-iteration
# cost (its predicate check) without changing results.
UNROLL = 8


def _unrolled(step):
    def body(st):
        for _ in range(UNROLL):
            st = step(st)
        return st
    return body



def _bulk_append(mems: Smems, mask: jax.Array, k, l, s, start, end,
                 out_cap: int) -> Smems:
    """Append masked [B, X] lanes (ascending lane order) to the [B, out_cap]
    SMEM buffers; overflow drops and sets the flag."""
    B = mask.shape[0]
    m32 = mask.astype(I32)
    rank = jnp.cumsum(m32, axis=1) - m32
    dest = jnp.where(mask, mems.n[:, None] + rank, out_cap)
    dest = jnp.minimum(dest, out_cap)
    rowsB = jnp.arange(B)[:, None]

    def scat(buf, vals):
        return buf.at[rowsB, dest].set(vals, mode="drop")

    n_added = jnp.sum((dest < out_cap).astype(I32), axis=1)
    dropped = jnp.any(mask & (dest >= out_cap), axis=1)
    return Smems(
        scat(mems.k, k), scat(mems.l, l), scat(mems.s, s),
        scat(mems.start, start), scat(mems.end, end),
        mems.n + n_added, mems.overflow | dropped)



def _take_q(q: jax.Array, i: jax.Array) -> jax.Array:
    """q: [B, L] or [lanes, L]-indexed by row map; i: same leading shape.

    Mask-sum instead of take_along_axis: an L=160 compare+reduce is plain
    elementwise work that fuses with its neighbours."""
    L = q.shape[-1]
    ids = jax.lax.broadcasted_iota(I32, q.shape, q.ndim - 1)
    qi = jnp.sum(jnp.where(ids == i[..., None], q, 0), axis=-1)
    return jnp.where((i >= 0) & (i < L), qi, 4)


def _mixed_ext(di: DeviceIndex, is_fwd, k, l, s, c):
    """One extension step for every lane: forward-append lanes swap k/l in
    and out; c is the (already complemented where needed) base per lane.
    Returns (nk, nl, ns) for the chosen base."""
    kk = jnp.where(is_fwd, l, k)
    ll = jnp.where(is_fwd, k, l)
    k_b, l_b, s_b = ext_core(di, kk, ll, s)
    nk0 = _pick_base(k_b, c)
    nl0 = _pick_base(l_b, c)
    ns = _pick_base(s_b, c)
    nk = jnp.where(is_fwd, nl0, nk0)
    nl = jnp.where(is_fwd, nk0, nl0)
    return nk, nl, ns


@functools.partial(jax.jit, static_argnames=("min_seed_len", "cap"))
def smem_round1_chain(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                      min_seed_len: int = 19, cap: int = 64) -> Smems:
    """All round-1 SMEMs (threshold 1) for a [B, L] read batch.

    Emissions arrive in ascending-start order per read (matching the scalar
    reference's round-1 order)."""
    B, L = q.shape
    idt = di.L2.dtype  # interval dtype: int32, or int64 for wide indexes
    q = q.astype(I32)
    lens = lens.astype(I32)
    slotsC = jnp.arange(cap, dtype=I32)
    zeroB = jnp.zeros((B,), I32)
    zeroK = jnp.zeros((B,), idt)

    st = dict(
        mode=jnp.where(lens > 0, jnp.full((B,), FRESH, I32),
                       jnp.full((B,), DONE, I32)),
        i=zeroB, j=zeroB, start=zeroB, e_anchor=zeroB,
        k=zeroK, l=zeroK, s=zeroK,
        bk=zeroK, bl=zeroK, bs=zeroK,
        m5=jnp.zeros((B, cap, 5), idt),
        mn=zeroB, ovf=jnp.zeros((B,), bool),
    )

    def cond(st):
        return jnp.any(st["mode"] != DONE)

    def step(st):
        mode, i, j = st["mode"], st["i"], st["j"]
        fresh = mode == FRESH
        fwd = mode == FWD
        bwd = mode == BWD

        # a lane is in exactly one mode, so ONE mask-sum lookup serves
        # both the FRESH/FWD q[i] uses and the BWD q[j] use (the [B, L]
        # compare+reduce is ~half the per-step vector work)
        qs = _take_q(q, jnp.where(bwd, j, i))
        qi = qs
        qj = qs

        # one shared extension per iteration: FWD lanes append q[i]
        # (complement pick), BWD lanes prepend q[j]
        c = jnp.where(fwd, 3 - jnp.clip(qi, 0, 3), jnp.clip(qj, 0, 3))
        ek, el, es = jnp.where(bwd, st["bk"], st["k"]), \
            jnp.where(bwd, st["bl"], st["l"]), \
            jnp.where(bwd, st["bs"], st["s"])
        nk, nl, ns = _mixed_ext(di, fwd, ek, el, es, c)

        # ---- FRESH ----
        f_end = fresh & (i >= lens)
        f_amb = fresh & ~f_end & (qi > 3)
        f_root = fresh & ~f_end & ~f_amb
        iv0 = set_intv(di, jnp.where(f_root, qi, 0))

        # ---- FWD ----
        f_stopx = fwd & ((i >= lens) | (qi > 3))        # end or N
        take = fwd & ~f_stopx & ((ns == st["s"]) | (ns >= 1))
        f_drop = fwd & ~f_stopx & ~take                 # occ-drop at i
        emit = (f_stopx | f_drop) & (i - st["start"] >= min_seed_len)

        # ---- BWD ----
        b_fail = bwd & ((j < 0) | (qj > 3) | (ns < 1))
        b_take = bwd & ~b_fail

        # emissions (at most one per lane per iteration) as a masked select
        # over the [B, cap] slot axis instead of a scatter
        eok = emit & (st["mn"] < cap)
        vals = jnp.stack(
            [st["k"], st["l"], st["s"],
             st["start"].astype(st["k"].dtype),
             i.astype(st["k"].dtype)], axis=-1)
        upd = eok[:, None] & (slotsC == st["mn"][:, None])
        m5 = jnp.where(upd[:, :, None], vals[:, None, :], st["m5"])
        mn = st["mn"] + eok.astype(I32)
        ovf = st["ovf"] | (emit & (st["mn"] >= cap))

        # ---- transitions ----
        new_mode = jnp.where(f_end, DONE, mode)
        new_mode = jnp.where(f_amb, FRESH, new_mode)
        new_mode = jnp.where(f_root, FWD, new_mode)
        new_mode = jnp.where(f_stopx, FRESH, new_mode)
        new_mode = jnp.where(f_drop, BWD, new_mode)
        new_mode = jnp.where(b_fail, FWD, new_mode)

        new_i = jnp.where(f_amb | f_root | take, i + 1, i)
        new_i = jnp.where(b_fail, st["e_anchor"], new_i)
        new_j = jnp.where(f_drop, i - 1, jnp.where(b_take, j - 1, j))

        new_start = jnp.where(f_root, i, st["start"])
        new_start = jnp.where(b_fail, j + 1, new_start)

        iv_drop = set_intv(di, jnp.where(f_drop, qi, 0))
        new_k = jnp.where(f_root, iv0.k, jnp.where(take, nk, st["k"]))
        new_l = jnp.where(f_root, iv0.l, jnp.where(take, nl, st["l"]))
        new_s = jnp.where(f_root, iv0.s, jnp.where(take, ns, st["s"]))
        new_k = jnp.where(b_fail, st["bk"], new_k)
        new_l = jnp.where(b_fail, st["bl"], new_l)
        new_s = jnp.where(b_fail, st["bs"], new_s)

        new_bk = jnp.where(f_drop, iv_drop.k,
                           jnp.where(b_take, nk, st["bk"]))
        new_bl = jnp.where(f_drop, iv_drop.l,
                           jnp.where(b_take, nl, st["bl"]))
        new_bs = jnp.where(f_drop, iv_drop.s,
                           jnp.where(b_take, ns, st["bs"]))
        new_anchor = jnp.where(f_drop, i + 1, st["e_anchor"])

        return dict(
            mode=new_mode, i=new_i, j=new_j, start=new_start,
            e_anchor=new_anchor,
            k=new_k, l=new_l, s=new_s, bk=new_bk, bl=new_bl, bs=new_bs,
            m5=m5, mn=mn, ovf=ovf,
        )

    st = jax.lax.while_loop(cond, _unrolled(step), st)
    m5 = st["m5"]
    return Smems(k=m5[..., 0], l=m5[..., 1], s=m5[..., 2],
                 start=m5[..., 3], end=m5[..., 4], n=st["mn"],
                 overflow=st["ovf"])


@functools.partial(jax.jit, static_argnames=("min_seed_len", "cap"))
def smem_through_chain(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                       rd: jax.Array, mid: jax.Array, thr: jax.Array,
                       act: jax.Array, min_seed_len: int = 19,
                       cap: int = 32) -> Smems:
    """Round-2 chain: all threshold-`thr` SMEMs through position `mid`,
    one lane per (read, candidate).

    q/lens: [B, L]; rd/mid/thr/act: [G] lane -> read row / middle position /
    occ threshold / active.  Returns Smems with [G, cap] buffers (emissions
    in ascending-start order per lane, matching fm_ref.smem1 output)."""
    G = rd.shape[0]
    idt = di.L2.dtype
    slotsC = jnp.arange(cap, dtype=I32)
    zeroG = jnp.zeros((G,), I32)
    zeroK = jnp.zeros((G,), idt)
    qg = q[rd]                       # [G, L] (gather rows once)
    leng = lens[rd]

    qm = _take_q(qg, mid)
    iv0 = set_intv(di, jnp.where(act, qm, 0))
    st = dict(
        mode=jnp.where(act & (qm < 4), jnp.full((G,), BWD, I32),
                       jnp.full((G,), DONE, I32)),
        i=zeroG, j=mid - 1, start=mid, e_anchor=mid + 1,
        k=zeroK, l=zeroK, s=zeroK,
        bk=iv0.k, bl=iv0.l, bs=iv0.s,
        m5=jnp.zeros((G, cap, 5), idt),
        mn=zeroG, ovf=jnp.zeros((G,), bool),
    )

    def cond(st):
        return jnp.any(st["mode"] != DONE)

    def step(st):
        mode, i, j = st["mode"], st["i"], st["j"]
        fwd = mode == FWD
        bwd = mode == BWD
        qs = _take_q(qg, jnp.where(bwd, j, i))
        qi = qs
        qj = qs

        c = jnp.where(fwd, 3 - jnp.clip(qi, 0, 3), jnp.clip(qj, 0, 3))
        ek = jnp.where(bwd, st["bk"], st["k"])
        el = jnp.where(bwd, st["bl"], st["l"])
        es = jnp.where(bwd, st["bs"], st["s"])
        nk, nl, ns = _mixed_ext(di, fwd, ek, el, es, c)

        # ---- FWD ----
        f_stopx = fwd & ((i >= leng) | (qi > 3))
        take = fwd & ~f_stopx & ((ns == st["s"]) | (ns >= thr))
        f_drop = fwd & ~f_stopx & ~take
        emit = (f_stopx | f_drop) & (i - st["start"] >= min_seed_len)

        # ---- BWD ----
        b_fail = bwd & ((j < 0) | (qj > 3) | (ns < thr))
        b_take = bwd & ~b_fail
        b_root = jnp.where(b_fail, j + 1, st["start"])
        b_over = b_fail & (b_root > mid)     # next root past mid -> done

        eok = emit & (st["mn"] < cap)
        vals = jnp.stack(
            [st["k"], st["l"], st["s"],
             st["start"].astype(st["k"].dtype),
             i.astype(st["k"].dtype)], axis=-1)
        upd = eok[:, None] & (slotsC == st["mn"][:, None])
        m5 = jnp.where(upd[:, :, None], vals[:, None, :], st["m5"])
        mn = st["mn"] + eok.astype(I32)
        ovf = st["ovf"] | (emit & (st["mn"] >= cap))

        new_mode = jnp.where(f_stopx, DONE, mode)       # N/end: chain over
        new_mode = jnp.where(f_drop, BWD, new_mode)
        new_mode = jnp.where(b_fail, jnp.where(b_over, DONE, FWD), new_mode)

        new_i = jnp.where(take, i + 1, i)
        new_i = jnp.where(b_fail & ~b_over, st["e_anchor"], new_i)
        new_j = jnp.where(f_drop, i - 1, jnp.where(b_take, j - 1, j))
        new_start = jnp.where(b_fail & ~b_over, b_root, st["start"])

        iv_drop = set_intv(di, jnp.where(f_drop, qi, 0))
        new_k = jnp.where(take, nk, st["k"])
        new_l = jnp.where(take, nl, st["l"])
        new_s = jnp.where(take, ns, st["s"])
        new_k = jnp.where(b_fail, st["bk"], new_k)
        new_l = jnp.where(b_fail, st["bl"], new_l)
        new_s = jnp.where(b_fail, st["bs"], new_s)
        new_bk = jnp.where(f_drop, iv_drop.k,
                           jnp.where(b_take, nk, st["bk"]))
        new_bl = jnp.where(f_drop, iv_drop.l,
                           jnp.where(b_take, nl, st["bl"]))
        new_bs = jnp.where(f_drop, iv_drop.s,
                           jnp.where(b_take, ns, st["bs"]))
        new_anchor = jnp.where(f_drop, i + 1, st["e_anchor"])

        return dict(
            mode=new_mode, i=new_i, j=new_j, start=new_start,
            e_anchor=new_anchor,
            k=new_k, l=new_l, s=new_s, bk=new_bk, bl=new_bl, bs=new_bs,
            m5=m5, mn=mn, ovf=ovf,
        )

    st = jax.lax.while_loop(cond, _unrolled(step), st)
    m5 = st["m5"]
    return Smems(k=m5[..., 0], l=m5[..., 1], s=m5[..., 2],
                 start=m5[..., 3], end=m5[..., 4], n=st["mn"],
                 overflow=st["ovf"])


@functools.partial(jax.jit, static_argnames=(
    "min_seed_len", "max_mem_intv", "cap"))
def smem_round3_chain(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                      min_seed_len: int = 19, max_mem_intv: int = 20,
                      cap: int = 64) -> Smems:
    """Round-3 chain: LAST-like forward-only restart seeding
    (fm_ref.seed_strategy1 restart loop), one lane per read."""
    B, L = q.shape
    q = q.astype(I32)
    lens = lens.astype(I32)
    slotsC = jnp.arange(cap, dtype=I32)
    zeroB = jnp.zeros((B,), I32)

    EXT3 = 1
    idt = di.L2.dtype
    zeroK = jnp.zeros((B,), idt)
    st = dict(
        mode=jnp.where(lens > 0, jnp.full((B,), FRESH, I32),
                       jnp.full((B,), DONE, I32)),
        i=zeroB, x=zeroB,
        k=zeroK, l=zeroK, s=zeroK,
        m5=jnp.zeros((B, cap, 5), idt),
        mn=zeroB, ovf=jnp.zeros((B,), bool),
    )

    def cond(st):
        return jnp.any(st["mode"] != DONE)

    def step(st):
        mode, i = st["mode"], st["i"]
        fresh = mode == FRESH
        ext3 = mode == EXT3
        qi = _take_q(q, i)

        c = 3 - jnp.clip(qi, 0, 3)
        nk, nl, ns = _mixed_ext(
            di, jnp.ones_like(mode, bool), st["k"], st["l"], st["s"], c)

        # ---- FRESH ----
        f_end = fresh & (i >= lens)
        f_amb = fresh & ~f_end & (qi > 3)
        f_root = fresh & ~f_end & ~f_amb
        iv0 = set_intv(di, jnp.where(f_root, qi, 0))

        # ---- EXT3 ----
        e_end = ext3 & (i >= lens)
        e_amb = ext3 & ~e_end & (qi > 3)
        can = ext3 & ~e_end & ~e_amb
        hit = can & (ns < max_mem_intv) & (i - st["x"] >= min_seed_len)
        found = hit & (ns > 0)
        adv = can & ~hit

        eok = found & (st["mn"] < cap)
        vals = jnp.stack([nk, nl, ns, st["x"].astype(nk.dtype),
                          (i + 1).astype(nk.dtype)], axis=-1)
        upd = eok[:, None] & (slotsC == st["mn"][:, None])
        m5 = jnp.where(upd[:, :, None], vals[:, None, :], st["m5"])
        mn = st["mn"] + eok.astype(I32)
        ovf = st["ovf"] | (found & (st["mn"] >= cap))

        new_mode = jnp.where(f_end | e_end, DONE, mode)
        new_mode = jnp.where(f_root, EXT3, new_mode)
        new_mode = jnp.where(e_amb | hit, FRESH, new_mode)

        new_i = jnp.where(f_amb | f_root | adv | e_amb | hit, i + 1, i)
        new_x = jnp.where(f_root, i, st["x"])
        new_k = jnp.where(f_root, iv0.k, jnp.where(adv, nk, st["k"]))
        new_l = jnp.where(f_root, iv0.l, jnp.where(adv, nl, st["l"]))
        new_s = jnp.where(f_root, iv0.s, jnp.where(adv, ns, st["s"]))

        return dict(
            mode=new_mode, i=new_i, x=new_x,
            k=new_k, l=new_l, s=new_s,
            m5=m5, mn=mn, ovf=ovf,
        )

    st = jax.lax.while_loop(cond, _unrolled(step), st)
    m5 = st["m5"]
    return Smems(k=m5[..., 0], l=m5[..., 1], s=m5[..., 2],
                 start=m5[..., 3], end=m5[..., 4], n=st["mn"],
                 overflow=st["ovf"])


@functools.partial(jax.jit, static_argnames=(
    "min_seed_len", "split_len", "split_width", "out_cap"))
def _smem_r1_prep(di: DeviceIndex, q: jax.Array, lens: jax.Array, *,
                  min_seed_len: int, split_len: int, split_width: int,
                  out_cap: int):
    """Stage 1: round-1 SMEMs appended into fresh output buffers + the
    round-2 candidate compaction table (read-major order)."""
    B, L = q.shape
    idt = di.L2.dtype
    zero_out = jnp.zeros((B, out_cap), dtype=idt)
    slot_ids = jnp.arange(out_cap, dtype=I32)[None, :]
    mems = Smems(k=zero_out, l=zero_out, s=zero_out, start=zero_out,
                 end=zero_out, n=jnp.zeros(B, dtype=I32),
                 overflow=jnp.zeros(B, dtype=bool))
    r1 = smem_round1_chain(di, q, lens, min_seed_len=min_seed_len,
                           cap=out_cap)
    m1 = slot_ids < r1.n[:, None]
    mems = _bulk_append(mems, m1, r1.k, r1.l, r1.s, r1.start, r1.end,
                        out_cap)
    mems = mems._replace(overflow=mems.overflow | r1.overflow)

    cand = m1 & ((r1.end - r1.start) >= split_len) & (r1.s <= split_width)
    NC = B * out_cap
    flat_cand = cand.reshape(NC)
    fc = flat_cand.astype(I32)
    grank = jnp.cumsum(fc) - fc
    total = jnp.sum(fc)
    src_tab = jnp.zeros((NC,), I32).at[
        jnp.where(flat_cand, grank, NC)].set(
        jnp.arange(NC, dtype=I32), mode="drop")
    return (mems, src_tab, r1.start.reshape(NC), r1.end.reshape(NC),
            r1.s.reshape(NC), total)


def _smem_r2_wave(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                  mems: Smems, src_tab, r1_start, r1_end, r1_s, total, w, *,
                  min_seed_len: int, r2_cap: int, out_cap: int, G: int
                  ) -> Smems:
    """Stage 2 (one wave of G lanes): round-2 through-chains for candidates
    [w*G, (w+1)*G) with segmented append into the output buffers."""
    B = q.shape[0]
    NC = src_tab.shape[0]
    laneG = jnp.arange(G, dtype=I32)
    e_ids = jnp.arange(r2_cap, dtype=I32)[None, :]
    gidx = w * G + laneG
    act = gidx < total
    sf = src_tab[jnp.minimum(gidx, NC - 1)]
    rd = sf // out_cap
    mid = jnp.where(act, ((r1_start[sf] + r1_end[sf]) >> 1
                          ).astype(I32), 0)
    thr = jnp.where(act, r1_s[sf] + 1, 1)
    sub = smem_through_chain(di, q, lens, rd, mid, thr, act,
                             min_seed_len=min_seed_len, cap=r2_cap)
    # segmented append: lanes of one read are consecutive, so each
    # lane's write base is (emissions of earlier same-read lanes)
    en = jnp.where(act, sub.n, 0)
    before = jnp.cumsum(en) - en
    first = jnp.concatenate(
        [jnp.ones((1,), bool), rd[1:] != rd[:-1]])
    base = jax.lax.cummax(jnp.where(first, before, -1))
    off = before - base
    emask = act[:, None] & (e_ids < sub.n[:, None])
    dest_u = mems.n[rd][:, None] + off[:, None] + e_ids
    ok = emask & (dest_u < out_cap)
    dest = jnp.where(ok, dest_u, out_cap)
    rows = jnp.broadcast_to(rd[:, None], dest.shape)

    def scat(buf, vals):
        return buf.at[rows, dest].set(vals, mode="drop")

    n_add = jnp.zeros((B,), I32).at[rd].add(
        jnp.sum(ok.astype(I32), axis=1).astype(I32))
    drop = jnp.zeros((B,), I32).at[rd].max(
        (jnp.any(emask & ~ok, axis=1) | sub.overflow).astype(I32))
    return Smems(
        scat(mems.k, sub.k), scat(mems.l, sub.l), scat(mems.s, sub.s),
        scat(mems.start, sub.start), scat(mems.end, sub.end),
        mems.n + n_add, mems.overflow | (drop > 0))


@functools.partial(jax.jit, static_argnames=(
    "min_seed_len", "r2_cap", "out_cap", "G"))
def _smem_r2_loop(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                  mems: Smems, src_tab, r1_start, r1_end, r1_s, total, *,
                  min_seed_len: int, r2_cap: int, out_cap: int, G: int
                  ) -> Smems:
    """Stage 2: all round-2 waves as ONE device program (lax.while_loop
    over G-lane waves): no per-batch host sync and no per-wave dispatches
    of a host-driven loop."""

    def cond(state):
        w, _ = state
        return w * G < total

    def body(state):
        w, mems = state
        return w + 1, _smem_r2_wave(
            di, q, lens, mems, src_tab, r1_start, r1_end, r1_s, total, w,
            min_seed_len=min_seed_len, r2_cap=r2_cap, out_cap=out_cap, G=G)

    _, mems = jax.lax.while_loop(cond, body, (jnp.zeros((), I32), mems))
    return mems


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _r3_append(mems: Smems, r3: Smems, out_cap: int) -> Smems:
    """Append round-3 emissions into the output buffers (own program)."""
    slot_ids = jnp.arange(out_cap, dtype=I32)[None, :]
    m3 = slot_ids < r3.n[:, None]
    out = _bulk_append(mems, m3, r3.k, r3.l, r3.s, r3.start, r3.end,
                       out_cap)
    return out._replace(overflow=out.overflow | r3.overflow)


@functools.partial(jax.jit, static_argnames=("L", "out_cap"))
def _sort_order(mems: Smems, L: int, out_cap: int) -> jax.Array:
    """Per-read (start, end) argsort via the bitonic network (own
    program, see _smem_r3_sort)."""
    from tpubwa.ops.sortnet import bitonic_argsort

    slot_ids = jnp.arange(out_cap, dtype=I32)[None, :]
    in_use = slot_ids < mems.n[:, None]
    key = jnp.where(in_use, mems.start * (L + 2) + mems.end, BIG)
    return bitonic_argsort(key)


@jax.jit
def _apply_order(mems: Smems, sorder: jax.Array) -> Smems:
    ta = lambda a: jnp.take_along_axis(a, sorder, axis=1)  # noqa: E731
    return Smems(ta(mems.k), ta(mems.l), ta(mems.s), ta(mems.start),
                 ta(mems.end), mems.n, mems.overflow)


def _smem_r3_sort(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                  mems: Smems, *, min_seed_len: int, max_mem_intv: int,
                  out_cap: int) -> Smems:
    """Stage 3: round-3 restart seeding + final per-read (start, end) sort
    (bitonic network — no XLA sorts).

    Deliberately FOUR separate device programs (chain / append / argsort /
    gather), not one: a fused program of the 21-layer bitonic network, the
    while_loop chain and the 5-column scatter/gathers once took minutes to
    compile.  Split at those boundaries the stages are bit-identical (all
    dispatches stay async; no host sync is introduced).  Whether the split
    still pays on the GPU is not measured."""
    B, L = q.shape
    if max_mem_intv > 0:
        r3 = smem_round3_chain(di, q, lens, min_seed_len=min_seed_len,
                               max_mem_intv=max_mem_intv, cap=out_cap)
        mems = _r3_append(mems, r3, out_cap)
    sorder = _sort_order(mems, L, out_cap)
    return _apply_order(mems, sorder)


def collect_smems_chain(di: DeviceIndex, q: jax.Array, lens: jax.Array,
                        min_seed_len: int = 19, split_len: int = 28,
                        split_width: int = 10, max_mem_intv: int = 20,
                        out_cap: int = 64, r2_lanes: int | None = None,
                        r2_cap: int = 32) -> Smems:
    """Full 3-round SMEM collection (fm_ref.collect_smems semantics) built
    from the chain engines.  Output sorted by (start, end) per read.

    Round-2 candidates are compacted globally (read-major order) into waves
    of `r2_lanes` chain lanes, so lane count tracks the actual candidate
    load instead of a per-read worst case.  No XLA sorts anywhere: candidate
    compaction is cumsum+scatter and the final per-read (start, end) sort is
    a bitonic network (ops.sortnet).

    NOT itself jitted: fusing all three rounds + the wave loop into one XLA
    program once compiled for many minutes for no steady-state benefit —
    the three stages are dispatched as separate compiled programs.  Fully
    async: the round-2 wave loop
    is a device-side lax.while_loop, so there is no host sync anywhere in
    seeding.  Results are unchanged (the split is pure program
    partitioning)."""
    B, L = q.shape
    q = q.astype(I32)
    lens = lens.astype(I32)
    if r2_lanes is None:
        r2_lanes = 2 * B
    G = r2_lanes

    mems, src_tab, r1_start, r1_end, r1_s, total = _smem_r1_prep(
        di, q, lens, min_seed_len=min_seed_len, split_len=split_len,
        split_width=split_width, out_cap=out_cap)
    mems = _smem_r2_loop(
        di, q, lens, mems, src_tab, r1_start, r1_end, r1_s, total,
        min_seed_len=min_seed_len, r2_cap=r2_cap, out_cap=out_cap, G=G)
    return _smem_r3_sort(di, q, lens, mems, min_seed_len=min_seed_len,
                         max_mem_intv=max_mem_intv, out_cap=out_cap)


def collect_smems_chain_fused(di: DeviceIndex, q: jax.Array,
                              lens: jax.Array, min_seed_len: int = 19,
                              split_len: int = 28, split_width: int = 10,
                              max_mem_intv: int = 20, out_cap: int = 64,
                              r2_lanes: int | None = None,
                              r2_cap: int = 32) -> Smems:
    """Fully traceable single-program variant (the round-2 wave loop is a
    lax.while_loop) for callers that fuse seeding into a larger jit (the
    flagship device_align_step).  Only used at small demo shapes — at
    production shapes the fused program's compile time is pathological;
    the pipeline uses the staged collect_smems_chain above."""
    B, L = q.shape
    q = q.astype(I32)
    lens = lens.astype(I32)
    if r2_lanes is None:
        r2_lanes = 2 * B
    G = r2_lanes

    mems, src_tab, r1_start, r1_end, r1_s, total = _smem_r1_prep(
        di, q, lens, min_seed_len=min_seed_len, split_len=split_len,
        split_width=split_width, out_cap=out_cap)

    def cond(state):
        w, _ = state
        return w * G < total

    def body(state):
        w, mems = state
        return w + 1, _smem_r2_wave(
            di, q, lens, mems, src_tab, r1_start, r1_end, r1_s, total, w,
            min_seed_len=min_seed_len, r2_cap=r2_cap, out_cap=out_cap, G=G)

    _, mems = jax.lax.while_loop(cond, body, (jnp.zeros((), I32), mems))
    return _smem_r3_sort(di, q, lens, mems, min_seed_len=min_seed_len,
                         max_mem_intv=max_mem_intv, out_cap=out_cap)
