"""Device-side FM-index search primitives (JAX).

Batched re-expression of bwa-mem2's backward search (reference: [src]
FMI_search.cpp backwardExt :1154-1220 and the GET_OCC checkpoint macro,
surveyed in SURVEY.md §2.1): each occ query is ONE gather row from the fused
``cp[nblocks, 8]`` int32 tensor (4 cumulative counts + 64 BWT symbols packed
2-bit into 4 words), followed by in-register popcount — the device analog of
the reference's one-cache-line GET_OCC design.

All functions are shape-polymorphic over leading batch dims and jit-safe.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpubwa.index.fmindex import FMIndex


class DeviceIndex(NamedTuple):
    """Device-resident FM-index tensors.

    Two dtype layouts share one code path (every op derives its interval
    dtype from ``L2.dtype``):

    - **narrow** (seq_len + 1 < 2^31): everything int32 — the fused
      ``cp[nblocks, 8]`` row is 32 B, one gather per occ query.
    - **wide** (>= 2^31, e.g. GRCh38's 6.2 Gbp index text): SA/intervals/
      counts are int64; ``cp`` is int64 [nblocks, 8] (cols 4..7 still hold
      the 2-bit-packed BWT words, valued < 2^32) so an occ query remains
      ONE 64-byte gather row — the GET_OCC one-cache-line design at twice
      the line size.  Requires jax x64 (enabled by the Aligner when it
      loads a wide index).
    """

    cp: jax.Array         # int32|int64 [nblocks, 8]
    sa: jax.Array         # int32|int64 [N+1]
    pac_words: jax.Array  # uint32 [ceil(l_pac/16)]
    L2: jax.Array         # int32|int64 [5]
    primary: jax.Array    # int32|int64 scalar
    l_pac: jax.Array      # int32|int64 scalar

    @classmethod
    def from_host(cls, idx: FMIndex, wide: bool | None = None,
                  sa_stub: bool = False) -> "DeviceIndex":
        if wide is None:
            wide = idx.seq_len + 1 >= 1 << 31
        if not wide:
            # host combine of the 5-byte split storage; values < 2^31 here
            return cls(
                cp=jnp.asarray(idx.cp, dtype=jnp.int32),
                sa=jnp.asarray(idx.sa_ls[:1].view(np.int32) if sa_stub
                               else idx.sa_ls.view(np.int32)),
                pac_words=jnp.asarray(idx.pac_words, dtype=jnp.uint32),
                L2=jnp.asarray(idx.L2, dtype=jnp.int32),
                primary=jnp.int32(idx.primary),
                l_pac=jnp.int32(idx.l_pac),
            )
        import jax as _jax

        if not _jax.config.jax_enable_x64:
            raise RuntimeError(
                "wide (>=2^31) index serving needs jax x64 "
                "(jax.config.update('jax_enable_x64', True) — the Aligner "
                "does this automatically when loading a wide index)")
        cp_wide = np.zeros((idx.cp.shape[0], 8), dtype=np.int64)
        counts = idx.cp[:, 0:4].view(np.uint32).astype(np.int64)
        if idx.cp_hi is not None:   # >=2^31 builds carry the high words
            counts |= idx.cp_hi.astype(np.int64) << 32
        cp_wide[:, 0:4] = counts
        cp_wide[:, 4:8] = idx.cp[:, 4:8].view(np.uint32)
        sa64 = (np.asarray([int(idx.sa_ls[0]) | (int(idx.sa_ms[0]) << 32)],
                           np.int64) if sa_stub
                else idx.sa.astype(np.int64))
        return cls(
            cp=jnp.asarray(cp_wide),
            sa=jnp.asarray(sa64),
            pac_words=jnp.asarray(idx.pac_words, dtype=jnp.uint32),
            L2=jnp.asarray(idx.L2, dtype=jnp.int64),
            primary=jnp.int64(idx.primary),
            l_pac=jnp.int64(idx.l_pac),
        )


class BiInterval(NamedTuple):
    """Bidirectional SA interval: [k, k+s) for pattern P, [l, l+s) for
    revcomp(P).  All int32, arbitrary (shared) batch shape."""

    k: jax.Array
    l: jax.Array
    s: jax.Array


_EQ_PAT = np.array(
    [0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF], dtype=np.uint32)


def occ4(cp: jax.Array, primary: jax.Array, i: jax.Array) -> jax.Array:
    """occ_full(c, i) for all 4 bases.

    i: int32 [...], values in [0, N+1].  Returns int32 [..., 4]:
    counts of each base in BWT_full[0:i) (sentinel row handled via the
    primary-shift; the sentinel itself is never counted here).
    """
    j = i - (i > primary).astype(i.dtype)
    blk = j >> 6
    off = (j & 63).astype(jnp.int32)
    row = cp[blk]                       # [..., 8] one gather per query
    counts = row[..., 0:4]
    if row.dtype == jnp.int64:          # wide layout: words valued < 2^32
        words = row[..., 4:8].astype(jnp.uint32)
    else:
        words = jax.lax.bitcast_convert_type(row[..., 4:8],
                                             jnp.uint32)  # [..., 4]

    # per-word prefix lengths within the block: p_w = clip(off - 16w, 0, 16)
    w_ids = jnp.arange(4, dtype=jnp.int32)
    p = jnp.clip(off[..., None] - 16 * w_ids, 0, 16)          # [..., 4]
    two_p = (2 * p).astype(jnp.uint32)
    mask = jnp.where(
        p >= 16,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << two_p) - jnp.uint32(1),
    )                                                          # [..., 4]

    pat = jnp.asarray(_EQ_PAT)                                 # [4]
    x = words[..., None, :] ^ pat[:, None]                     # [..., 4c, 4w]
    neq_bits = (x | (x >> 1)) & jnp.uint32(0x55555555)
    neq = jax.lax.population_count(neq_bits & mask[..., None, :])
    neq_tot = jnp.sum(neq.astype(jnp.int32), axis=-1)          # [..., 4c]
    eq_tot = off[..., None] - neq_tot                          # p.sum() == off
    return counts + eq_tot


def ext_core(di: DeviceIndex, kk: jax.Array, ll: jax.Array,
             s: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Raw bidirectional extension math on an explicit (kk, ll, s) pair:
    the backward-prepend update.  Returns (k_b, l_b, s_b), each [..., 4].
    Callers express forward (append) steps by swapping k/l on the way in
    and out (the classic bidirectional-index trick)."""
    # one fused gather for both endpoints (gathers dominate the chain step)
    occ2 = occ4(di.cp, di.primary,
                jnp.stack([kk, kk + s], axis=-1))  # [..., 2, 4]
    occ_k = occ2[..., 0, :]
    occ_ks = occ2[..., 1, :]
    s_b = occ_ks - occ_k
    k_b = di.L2[0:4] + occ_k

    # sentinel row inside [kk, kk+s) consumes one slot of the co-interval
    sent = ((kk <= di.primary) & (di.primary < kk + s)).astype(jnp.int32)
    l3 = ll + sent
    l2 = l3 + s_b[..., 3]
    l1 = l2 + s_b[..., 2]
    l0 = l1 + s_b[..., 1]
    l_b = jnp.stack([l0, l1, l2, l3], axis=-1)
    return k_b, l_b, s_b


def backward_ext_all(di: DeviceIndex, ik: BiInterval,
                     is_back: bool) -> BiInterval:
    """Extend the bi-interval by every base at once.

    is_back=True: prepend base b to the pattern (backward search step).
    is_back=False: append base b (forward step, via the revcomp interval).
    Returns BiInterval with trailing axis 4 (one per base b in 0..3).
    Semantics follow the classic bidirectional extension (the reference's
    backwardExt / bwa's bwt_extend).
    """
    kk = ik.k if is_back else ik.l
    ll = ik.l if is_back else ik.k
    k_b, l_b, s_b = ext_core(di, kk, ll, ik.s)
    if is_back:
        return BiInterval(k=k_b, l=l_b, s=s_b)
    return BiInterval(k=l_b, l=k_b, s=s_b)


def set_intv(di: DeviceIndex, c: jax.Array) -> BiInterval:
    """Initial bi-interval for a single base c (0..3); c is clipped, callers
    must mask ambiguous bases themselves.  L2 lookups are mask-sums over
    the 5-entry table instead of gathers."""
    c = jnp.clip(c, 0, 3).astype(jnp.int32)
    ids = jnp.arange(5, dtype=jnp.int32)

    def pick(idx):
        sel = ids == idx[..., None]
        return jnp.sum(jnp.where(sel, di.L2, 0), axis=-1)

    k = pick(c)
    s = pick(c + 1) - k
    l = pick(3 - c)
    return BiInterval(k=k, l=l, s=s)


def sa_lookup(di: DeviceIndex, r: jax.Array) -> jax.Array:
    """Suffix-array positions for rows r (int32 [...])."""
    return di.sa[r]


# ------------------------------------------------------- sampled SA ----
#
# Big-genome single-card serving (SURVEY.md §5): a full-resolution wide
# device SA is 8 B/row — 19.2 GB for the 1.2 Gbp wide fixture, 50 GB at
# GRCh38 scale.  bwa classic solves this with a sampled SA + LF-walk
# (bwt_sa / bwt_invPsi); this re-expression samples by SUFFIX
# POSITION (rows r with sa[r] % 2^shift == 0) so the walk is BOUNDED at
# 2^shift - 1 LF steps (row-index sampling, bwa's choice, has an
# unbounded tail — unusable in a fixed-trip device loop).  Each walk step
# is two fused gathers per lane (occ checkpoint row + sample-rank row);
# results are EXACTLY those of the full SA (parity-pinned by
# tests/test_sampled_sa.py) — sampling changes cost, not output.


class SampledSA(NamedTuple):
    """Position-sampled suffix array + rank directory.

    blocks: int32|int64 [nblocks, 4] — per 64 rows: (rank_before,
            mask_lo, mask_hi, 0); mask bit b set <=> row 64*blk + b is
            sampled (its suffix position % 2^shift == 0)
    vals:   int32|int64 [n_sampled] — suffix positions of sampled rows in
            row order
    """

    blocks: jax.Array
    vals: jax.Array


def build_sampled_sa(sa_host, shift: int, wide: bool,
                     idx=None) -> "SampledSA":
    """Host-side construction, CHUNKED: a Gbp-scale SA is ~19 GB as
    int64, and the naive vectorized build held ~60 GB of transients
    (measured 30+ min of page-fault-bound numpy on the 1.2 Gbp index).
    Chunks of 64M rows keep the working set ~1 GB.

    Pass ``idx`` (FMIndex) instead of ``sa_host`` to avoid materializing
    the full int64 SA at all — chunks combine the 5-byte split storage
    (sa_ls/sa_ms) on the fly."""
    intv = 1 << shift
    if idx is not None:
        n = idx.sa_ls.shape[0]

        def chunk(lo, hi):
            return (idx.sa_ls[lo:hi].astype(np.int64)
                    | (idx.sa_ms[lo:hi].astype(np.int64) << 32))
    else:
        n = sa_host.shape[0]

        def chunk(lo, hi):
            return sa_host[lo:hi]

    nblocks = (n + 63) // 64
    dt = np.int64 if wide else np.int32
    blocks = np.zeros((nblocks, 4), dtype=dt)
    vals_parts = []
    shifts32 = np.arange(32, dtype=np.uint32)[None, :]
    C = 1 << 26  # 64M rows per chunk (multiple of 64)
    rank = 0
    for lo in range(0, n, C):
        hi = min(lo + C, n)
        sa_c = chunk(lo, hi)
        mask = (sa_c % intv) == 0
        vals_parts.append(sa_c[mask].astype(dt))
        nb = (hi - lo + 63) // 64
        bits = np.zeros(nb * 64, dtype=bool)
        bits[: hi - lo] = mask
        w = bits.reshape(nb, 2, 32)
        words = (w.astype(np.uint32) << shifts32[None, :, :]).sum(
            axis=2, dtype=np.uint32)
        cnt = bits.reshape(nb, 64).sum(axis=1)
        b0 = lo // 64
        blocks[b0:b0 + nb, 0] = rank + np.cumsum(cnt) - cnt
        blocks[b0:b0 + nb, 1] = words[:, 0].view(np.int32)
        blocks[b0:b0 + nb, 2] = words[:, 1].view(np.int32)
        rank += int(cnt.sum())
    vals = np.concatenate(vals_parts) if vals_parts else \
        np.zeros(0, dtype=dt)
    return SampledSA(blocks=jnp.asarray(blocks),
                     vals=jnp.asarray(vals))


def lf_step(di: DeviceIndex, r: jax.Array) -> jax.Array:
    """One LF-mapping step: row of the suffix starting one base earlier
    (sa[lf(r)] == sa[r] - 1; caller guarantees sa[r] > 0).  One fused cp
    gather per lane: the checkpoint row yields both the BWT symbol at r
    and its occ count."""
    j = r - (r > di.primary).astype(r.dtype)
    blk = j >> 6
    off = (j & 63).astype(jnp.int32)
    row = di.cp[blk]                              # [..., 8]
    counts = row[..., 0:4]
    if row.dtype == jnp.int64:
        words = row[..., 4:8].astype(jnp.uint32)
    else:
        words = jax.lax.bitcast_convert_type(row[..., 4:8], jnp.uint32)

    # BWT symbol at row r: word (off >> 4), 2-bit field (off & 15)
    w_ids = jnp.arange(4, dtype=jnp.int32)
    w_sel = (off[..., None] >> 4) == w_ids
    word = jnp.sum(jnp.where(w_sel, words, jnp.uint32(0)), axis=-1)
    c = ((word >> (2 * (off & 15)).astype(jnp.uint32)) & 3).astype(
        jnp.int32)

    # occ(c, r): checkpoint count + popcount of equal symbols before off
    p = jnp.clip(off[..., None] - 16 * w_ids, 0, 16)
    two_p = (2 * p).astype(jnp.uint32)
    wmask = jnp.where(p >= 16, jnp.uint32(0xFFFFFFFF),
                      (jnp.uint32(1) << two_p) - jnp.uint32(1))
    pat = jnp.asarray(_EQ_PAT)
    c_sel = jnp.arange(4, dtype=jnp.int32) == c[..., None]
    x = words ^ jnp.sum(jnp.where(c_sel, pat, 0), axis=-1,
                        dtype=jnp.uint32)[..., None]
    neq_bits = (x | (x >> 1)) & jnp.uint32(0x55555555)
    neq = jax.lax.population_count(neq_bits & wmask)
    eq = off - jnp.sum(neq.astype(jnp.int32), axis=-1)
    occ_c = (jnp.sum(jnp.where(c_sel, counts, 0), axis=-1)
             + eq.astype(counts.dtype))
    l2c = jnp.sum(jnp.where(c_sel, di.L2[0:4], 0), axis=-1)
    return l2c + occ_c


def sa_lookup_sampled(di: DeviceIndex, ss: SampledSA, rows: jax.Array,
                      shift: int) -> jax.Array:
    """Suffix positions for rows via the sampled SA (exact; <= 2^shift - 1
    LF steps per lane, all lanes in lockstep)."""
    intv = 1 << shift
    n_vals = ss.vals.shape[0]

    def probe(r):
        brow = ss.blocks[r >> 6]                  # [..., 4] one gather
        off = (r & 63).astype(jnp.int32)
        lo = brow[..., 1].astype(jnp.uint32) & jnp.uint32(0xFFFFFFFF)
        hi = brow[..., 2].astype(jnp.uint32) & jnp.uint32(0xFFFFFFFF)
        in_hi = off >= 32
        word = jnp.where(in_hi, hi, lo)
        bit = ((word >> (off & 31).astype(jnp.uint32)) & 1).astype(
            jnp.bool_)
        m_lo = jnp.where(
            off >= 32, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (off & 31).astype(jnp.uint32))
            - jnp.uint32(1))
        m_lo = jnp.where(in_hi, jnp.uint32(0xFFFFFFFF), m_lo)
        m_hi = jnp.where(
            in_hi,
            (jnp.uint32(1)
             << jnp.clip(off - 32, 0, 31).astype(jnp.uint32))
            - jnp.uint32(1),
            jnp.uint32(0))
        rank = (brow[..., 0]
                + jax.lax.population_count(lo & m_lo).astype(brow.dtype)
                + jax.lax.population_count(hi & m_hi).astype(brow.dtype))
        return bit, rank

    def body(t, carry):
        r, res, done = carry
        bit, rank = probe(r)
        newly = bit & ~done
        v = ss.vals[jnp.clip(rank, 0, n_vals - 1)]
        res = jnp.where(newly, v + t, res)
        done = done | bit
        r = jnp.where(done, r, lf_step(di, r))
        return r, res, done

    r0 = rows
    res0 = jnp.zeros_like(rows)
    done0 = jnp.zeros(rows.shape, jnp.bool_)
    _, res, _ = jax.lax.fori_loop(0, intv, body, (r0, res0, done0))
    return res


def sa_lookup_sharded(mesh, sa: jax.Array, rows: jax.Array,
                      axis: str = "dp") -> jax.Array:
    """SA positions for global rows when ``sa`` is SHARDED over ``axis``
    (the GRCh38 serving mode: the SA is split over the cards' memory —
    fmindex.py sizing; SURVEY.md §5 distributed plan).

    Pattern: all_gather the (small) request vector over the mesh axis,
    every shard answers the requests that land in its slice, and a
    psum_scatter routes each answer back to the requesting device —
    exactly one shard hits per request, so the sum IS the answer.
    Traffic is O(n_devices * n_requests) int rows over ICI, never the
    O(N) SA itself.
    """
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    D = mesh.shape[axis]
    shard = sa.shape[0] // D

    def body(sa_loc, rows_loc):
        i = jax.lax.axis_index(axis)
        allrows = jax.lax.all_gather(rows_loc, axis)           # [D, n]
        loc = allrows - (i * shard).astype(allrows.dtype)
        hit = (loc >= 0) & (loc < shard)
        vals = jnp.where(hit, sa_loc[jnp.clip(loc, 0, shard - 1)], 0)
        return jax.lax.psum_scatter(vals, axis,
                                    scatter_dimension=0, tiled=False)

    try:    # jax.shard_map (v0.8+) dropped check_rep
        f = shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                      out_specs=P(axis))
    except TypeError:
        f = shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                      out_specs=P(axis), check_rep=False)
    return f(sa, rows)


def fetch_ref_batch(di: DeviceIndex, pos: jax.Array) -> jax.Array:
    """Reference codes at positions in 2*l_pac space (device gather from the
    2-bit packed forward reference).  Out-of-range positions return 4."""
    in_range = (pos >= 0) & (pos < 2 * di.l_pac)
    fwd = pos < di.l_pac
    p = jnp.where(fwd, pos, 2 * di.l_pac - 1 - pos)
    p = jnp.clip(p, 0, di.l_pac - 1)
    w = di.pac_words[p >> 4]
    code = (w >> ((p & 15).astype(jnp.uint32) * 2)) & 3
    code = code.astype(jnp.int32)
    code = jnp.where(fwd, code, 3 - code)
    return jnp.where(in_range, code, 4)


# ------------------------------------------- contiguous window fetch ----
#
# The extension hot path fetches CONSECUTIVE reference windows (the chain's
# rmax window around each seed, never crossing the l_pac strand boundary —
# native/extension.cpp clamps it).  A per-base gather costs one gathered
# element per base; fetching the 2-bit packed WORDS instead costs 1/16th
# the gather elements, and the unpack + per-row alignment shift is pure
# vector work (reference analog: the one-cache-line GET_OCC idea applied
# to the bandedSWA ref windows).


def _ref_window_block(di: DeviceIndex, lo: jax.Array, T: int) -> jax.Array:
    """Physical-coordinate codes [J, T] ascending from per-row ``lo``
    (forward-strand coords; lo may be negative or past l_pac — such slots
    hold garbage that callers mask by window length)."""
    J = lo.shape[0]
    WN = T // 16 + 1
    n_words = di.pac_words.shape[0]
    w_idx = (lo[:, None] >> 4) + jnp.arange(WN, dtype=jnp.int32)[None, :]
    words = di.pac_words[jnp.clip(w_idx, 0, n_words - 1)]      # [J, WN]
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    codes = (words[:, :, None] >> shifts) & jnp.uint32(3)      # [J, WN, 16]
    u = codes.reshape(J, WN * 16).astype(jnp.int32)
    o = lo & 15                                 # row phase within its word
    for s in (8, 4, 2, 1):                      # per-row left-shift by o
        shifted = jnp.concatenate(
            [u[:, s:], jnp.zeros((J, s), jnp.int32)], axis=1)
        u = jnp.where((o[:, None] & s) != 0, shifted, u)
    return u[:, :T]


def ref_window_right(di: DeviceIndex, start: jax.Array, T: int) -> jax.Array:
    """out[j, t] = ref code at (start[j] + t) in 2*l_pac coords, for a
    window that stays on one strand; slots past the strand-valid span are
    garbage (callers mask by tlen)."""
    rev = start >= di.l_pac
    hi = 2 * di.l_pac - 1 - start               # rev-strand physical top
    lo = jnp.where(rev, hi - (T - 1), start)
    block = _ref_window_block(di, lo, T)
    return jnp.where(rev[:, None], (3 - block)[:, ::-1], block)


def ref_window_left(di: DeviceIndex, b: jax.Array, T: int) -> jax.Array:
    """out[j, t] = ref code at (b[j] - 1 - t): a window read DESCENDING
    from b-1 (the left-extension target order); same masking contract."""
    rev = (b - 1) >= di.l_pac
    lo = jnp.where(rev, 2 * di.l_pac - b, b - T)
    block = _ref_window_block(di, lo, T)
    return jnp.where(rev[:, None], 3 - block, block[:, ::-1])
