"""Device seed expansion: SMEMs -> (rbeg, qbeg, len) seed hits via batched
suffix-array gathers.

Reference analog: the SA-lookup loop in mem_chain ([src] bwamem.cpp, via
get_sa_entry — SURVEY.md §3.1 "SAL" phase) with bwa's occurrence sampling:
intervals with more than max_occ hits are subsampled with stride occ/max_occ.
A per-read seed cap (the reference's MAX_SEED_HITS idea, SURVEY.md §2.1
shouldKeepSeed) bounds the fixed output shape; overflow is reported.

Also computes l_rep (bases covered by repetitive SMEMs, occ > max_occ) for
the frac_rep MAPQ correction.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpubwa.ops.fm import DeviceIndex
from tpubwa.ops.smem import Smems

I32 = jnp.int32


class SeedBatch(NamedTuple):
    rbeg: jax.Array   # [B, S] int32 position in 2*l_pac space
    qbeg: jax.Array   # [B, S] int32
    len: jax.Array    # [B, S] int32
    valid: jax.Array  # [B, S] bool
    n: jax.Array      # [B] int32
    overflow: jax.Array  # [B] bool (seed cap hit)
    l_rep: jax.Array  # [B] int32 repetitive-coverage length


@functools.partial(jax.jit, static_argnames=("max_occ", "out_seeds"))
def smems_to_seeds(di: DeviceIndex, sm: Smems, *, max_occ: int = 500,
                   out_seeds: int = 128) -> SeedBatch:
    B, M = sm.k.shape
    S = out_seeds
    in_use = jnp.arange(M)[None, :] < sm.n[:, None]
    occ = jnp.where(in_use, sm.s, 0)
    step = jnp.where(occ > max_occ, occ // max_occ, 1)
    cnt = jnp.minimum(occ, max_occ)

    # prefix layout: seed slot t belongs to smem m with off[m] <= t < off[m+1]
    off_end = jnp.cumsum(cnt, axis=1)                       # inclusive
    off_beg = off_end - cnt
    total = jnp.minimum(off_end[:, -1], S)

    t = jnp.arange(S, dtype=I32)[None, :]                   # [1, S]
    # m_idx[b, t] = index of smem owning slot t
    m_idx = jnp.sum((off_end[:, :, None] <= t[:, None, :]).astype(I32),
                    axis=1)                                 # [B, S]
    m_idx = jnp.clip(m_idx, 0, M - 1)
    valid = t < total[:, None]

    rows = jnp.arange(B)[:, None]
    j = t - off_beg[rows, m_idx]
    sa_row = sm.k[rows, m_idx] + j * step[rows, m_idx]
    rbeg = di.sa[jnp.clip(sa_row, 0, di.sa.shape[0] - 1)]
    qbeg = sm.start[rows, m_idx]
    slen = sm.end[rows, m_idx] - qbeg

    # drop seeds that bridge the forward/reverse boundary (contig-boundary
    # filtering happens on host where contig offsets live)
    bridge = (rbeg < di.l_pac) & (rbeg + slen > di.l_pac)
    valid = valid & ~bridge

    # l_rep: union length of query intervals of repetitive smems
    rep = in_use & (sm.s > max_occ)
    def body(carry, m):
        b_cur, e_cur, l_rep = carry
        sb = sm.start[:, m]
        se = sm.end[:, m]
        is_rep = rep[:, m]
        new_seg = is_rep & (sb > e_cur)
        l_rep = jnp.where(new_seg, l_rep + (e_cur - b_cur), l_rep)
        b_cur = jnp.where(new_seg, sb, b_cur)
        e_cur = jnp.where(is_rep, jnp.maximum(e_cur, se), e_cur)
        return (b_cur, e_cur, l_rep), None

    (b_cur, e_cur, l_rep), _ = jax.lax.scan(
        body, (jnp.zeros(B, I32), jnp.zeros(B, I32), jnp.zeros(B, I32)),
        jnp.arange(M))
    l_rep = l_rep + (e_cur - b_cur)

    return SeedBatch(
        rbeg=jnp.where(valid, rbeg, 0),
        qbeg=jnp.where(valid, qbeg, 0),
        len=jnp.where(valid, slen, 0),
        valid=valid,
        n=jnp.sum(valid.astype(I32), axis=1),
        overflow=off_end[:, -1] > S,
        l_rep=l_rep,
    )


class CompactSeeds(NamedTuple):
    packed: jax.Array   # [CAP, 4] int32 rows (read_id, rbeg, qbeg, len),
    #                     in (read, slot) order; rows >= n are zero
    n: jax.Array        # [] int32 number of valid rows
    l_rep: jax.Array    # [B] int32
    overflow: jax.Array  # [B] bool per-read seed-cap overflow


@functools.partial(jax.jit, static_argnames=("max_occ", "per_read_cap",
                                             "mesh", "shard_sa", "sa_shift"))
def seed_rows(di: DeviceIndex, sm: Smems, *, max_occ: int = 500,
              per_read_cap: int = 128, mesh=None, shard_sa: bool = False, ss=None,
              sa_shift: int = 0) -> CompactSeeds:
    """SMEMs -> dense [CAP, 4] seed rows (read_id, rbeg, qbeg, len) directly
    in compacted global layout (read-major, SMEM order within read).

    Fuses smems_to_seeds + compact_seeds without the padded [B, S]
    intermediate: per-SMEM hit counts (with bwa's occ/max_occ stride
    sampling) are laid out by a global cumsum; the slot->SMEM owner map is
    one scatter + cummax instead of an O(B*M*S) compare.  Semantically
    identical to smems_to_seeds row enumeration (tests pin equality).
    Per-read totals are capped at per_read_cap (the MAX_SEED_HITS analog)
    with per-read overflow flags; the dense output holds B * per_read_cap
    rows, so that cap is the only truncation (a smaller global bound once
    dropped every seed of the batch's last reads on repeat-rich genomes).
    Only the dense prefix is downloaded.
    """
    B, M = sm.k.shape
    idt = sm.k.dtype   # interval dtype: int64 for wide (>=2^31) indexes
    S = per_read_cap
    CAP = B * S
    in_use = jnp.arange(M)[None, :] < sm.n[:, None]
    occ = jnp.where(in_use, sm.s, 0)
    step = jnp.where(occ > max_occ, occ // max_occ, 1)
    # per-read slot counts are small (<= max_occ): back to int32
    cnt = jnp.minimum(occ, max_occ).astype(I32)

    # per-read prefix, truncated at the per-read cap S
    off_end_r = jnp.cumsum(cnt, axis=1)
    off_beg_r = off_end_r - cnt
    ob = jnp.minimum(off_beg_r, S)
    oe = jnp.minimum(off_end_r, S)
    cnt2 = oe - ob
    read_tot = oe[:, -1] if M > 0 else jnp.zeros((B,), I32)
    read_ovf = off_end_r[:, -1] > S

    # global layout: read b's seeds occupy [base[b], base[b] + read_tot[b])
    base = jnp.cumsum(read_tot) - read_tot
    n_total = base[-1] + read_tot[-1]
    g_beg = base[:, None] + ob                              # [B, M]

    # owner map: scatter each live SMEM's flat id at its first slot, cummax
    flat_id = jnp.arange(B * M, dtype=I32)
    live = (cnt2 > 0).reshape(-1)
    dst = jnp.where(live, g_beg.reshape(-1), CAP)
    owner = jnp.full((CAP,), -1, I32).at[dst].max(flat_id, mode="drop")
    owner = jax.lax.cummax(owner)
    owner = jnp.clip(owner, 0, B * M - 1)

    t = jnp.arange(CAP, dtype=I32)
    valid = t < n_total
    rd = owner // M
    j = t - g_beg.reshape(-1)[owner]
    sa_row = sm.k.reshape(-1)[owner] + (j * step.reshape(-1)[owner]
                                        ).astype(idt)
    if sa_shift > 0:
        # sampled-SA serving (big genomes on one card): bounded LF-walk,
        # exact results — ops.fm.sa_lookup_sampled
        from tpubwa.ops.fm import sa_lookup_sampled

        sa_row = jnp.clip(sa_row, 0, 2 * di.l_pac)  # rows span [0, N]
        rbeg = sa_lookup_sampled(di, ss, sa_row, sa_shift)
    elif shard_sa:
        from tpubwa.ops.fm import sa_lookup_sharded

        sa_row = jnp.clip(sa_row, 0, di.sa.shape[0] - 1)
        rbeg = sa_lookup_sharded(mesh, di.sa, sa_row)
    else:
        sa_row = jnp.clip(sa_row, 0, di.sa.shape[0] - 1)
        rbeg = di.sa[sa_row]
    qbeg = sm.start.reshape(-1)[owner]
    slen = sm.end.reshape(-1)[owner] - qbeg

    # drop seeds bridging the forward/reverse strand boundary
    bridge = (rbeg < di.l_pac) & (rbeg + slen > di.l_pac)
    keep = valid & ~bridge

    # compact the (rare) bridge-dropped rows out of the dense prefix
    k32 = keep.astype(I32)
    pos = jnp.cumsum(k32) - k32
    out_dst = jnp.where(keep, pos, CAP)
    rows = jnp.stack([rd.astype(idt), rbeg.astype(idt),
                      qbeg.astype(idt), slen.astype(idt)], axis=1)
    packed = jnp.zeros((CAP, 4), idt).at[out_dst].set(rows, mode="drop")
    n = jnp.sum(k32)

    # l_rep: union length of query intervals of repetitive SMEMs (vectorized
    # interval union; SMEMs are sorted by start within each read)
    rep = in_use & (sm.s > max_occ)
    end_m = jnp.where(rep, sm.end, 0)
    prev = jnp.concatenate(
        [jnp.zeros((B, 1), end_m.dtype),
         jax.lax.cummax(end_m, axis=1)[:, :-1]], axis=1)
    contrib = jnp.where(
        rep, jnp.maximum(0, sm.end - jnp.maximum(sm.start, prev)), 0)
    l_rep = jnp.sum(contrib, axis=1).astype(I32)

    return CompactSeeds(packed=packed, n=n, l_rep=l_rep, overflow=read_ovf)


@jax.jit
def compact_seeds(sb: SeedBatch) -> CompactSeeds:
    """Flatten the padded [B, S] seed batch into a dense [n, 4] row block.

    Download-size optimization: padded seed tensors are ~95% padding (most
    reads have <10 seeds) and the host only ever reads the valid rows, so
    scatter them to a dense prefix on device and ship just that.
    """
    import jax.numpy as jnp

    B, S = sb.rbeg.shape
    I32 = jnp.int32
    valid = sb.valid.reshape(-1)
    pos = jnp.cumsum(valid.astype(I32)) - 1
    dst = jnp.where(valid, pos, B * S)         # OOB rows -> dropped
    read_id = jnp.broadcast_to(
        jnp.arange(B, dtype=I32)[:, None], (B, S)).reshape(-1)
    rows = jnp.stack(
        [read_id, sb.rbeg.reshape(-1), sb.qbeg.reshape(-1),
         sb.len.reshape(-1)], axis=1)
    packed = jnp.zeros((B * S, 4), I32).at[dst].set(rows, mode="drop")
    return CompactSeeds(packed=packed, n=pos[-1] + 1, l_rep=sb.l_rep,
                        overflow=sb.overflow)
