"""Batched banded affine-gap seed extension (JAX, device).

Re-expression of the reference's inter-task-vectorized banded
Smith-Waterman (SURVEY.md §2.1 bandedSWA: one SIMD lane = one (query,target)
pair, SoA layout).  Here one *batch lane* = one extension job, and each DP
row is a fully vectorized [B, Q] update:

- gap-from-M recurrence (see ops.extend_ref): F has no sequential
  column dependency — it is an exclusive running max of (M - oe_ins +
  j*e_ins), computed with one cumulative-max per row (the
  "de(con)struction of the lazy-F loop" insight): the whole row becomes
  data-parallel elementwise work.
- per-lane band, h0, zdrop, early-exit (dead lanes are masked).

This is the plain core, compiled by XLA for any backend.  select_core
picks the Hopper kernel (ops.extend_cuda) in its place on the GPU.
Exact-equality property-tested against ops.extend_ref.extend_ref.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

I32 = jnp.int32
NEG = jnp.int32(-(1 << 30))


class ExtendBatchResult(NamedTuple):
    score: jax.Array
    qle: jax.Array
    tle: jax.Array
    gtle: jax.Array
    gscore: jax.Array
    max_off: jax.Array


def clamp_band_batch(w, qlen, mat_max: int, o_del: int, e_del: int,
                     o_ins: int, e_ins: int, end_bonus):
    """Vectorized ksw band clamp (floor() matches the C double->int cast
    for the non-negative values that occur here)."""
    max_ins = (qlen * mat_max + end_bonus - o_ins) // e_ins + 1
    w = jnp.minimum(w, jnp.maximum(max_ins, 1))
    max_del = (qlen * mat_max + end_bonus - o_del) // e_del + 1
    return jnp.minimum(w, jnp.maximum(max_del, 1))


def _extend_core(query: jax.Array, qlen: jax.Array, target: jax.Array,
                 tlen: jax.Array, mat: jax.Array, w: jax.Array,
                 h0: jax.Array, end_bonus: jax.Array, *,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (traceable core — see extend_batch).

    query:  [B, Q] int32 codes 0..4 (padded arbitrarily past qlen)
    target: [B, T] int32 codes 0..4 (padded arbitrarily past tlen)
    mat:    [5, 5] int32 scoring matrix with bwa_fill_scmat structure
            (match a on the ACGT diagonal, one mismatch value off it, one
            vs-N value in row/col 4) — scores are computed arithmetically
            from those three values instead of per-cell matrix gathers
    w / h0 / end_bonus / qlen / tlen: [B] int32 per-lane parameters
    """
    B, Q = query.shape
    _, T = target.shape
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    query = query.astype(I32)
    target = target.astype(I32)
    w = clamp_band_batch(w.astype(I32), qlen, mat_max, o_del, e_del,
                         o_ins, e_ins, end_bonus.astype(I32))

    jb = jnp.arange(Q, dtype=I32)[None, :]                 # [1, Q]
    mat = mat.astype(I32)
    s_match, s_mis, s_n = mat[0, 0], mat[0, 1], mat[0, 4]
    rows = jnp.arange(B)
    q_is_n = query >= 4                                    # [B, Q]

    # H boundary row i=-1: H(-1, j) = max(0, h0 - oe_ins - j*e_ins)
    h_init = jnp.maximum(h0[:, None] - oe_ins - jb * e_ins, 0)
    H_prev = jnp.concatenate([h0[:, None], h_init], axis=1)  # [B, Q+1]

    st = dict(
        i=jnp.zeros((), I32),
        H_prev=H_prev,
        E=jnp.zeros((B, Q), I32),
        M_prev=jnp.zeros((B, Q), I32),
        best=h0.astype(I32),
        best_i=jnp.full((B,), -1, I32),
        best_j=jnp.full((B,), -1, I32),
        max_ie=jnp.full((B,), -1, I32),
        gscore=jnp.full((B,), -1, I32),
        max_off=jnp.zeros((B,), I32),
        alive=(qlen > 0) & (tlen > 0),
    )

    def body(st, xs):
        i, t_i = xs                                         # t_i: [B]
        act = st["alive"] & (i < tlen)

        in_band = (jb >= i - w[:, None]) & (jb < i + w[:, None] + 1) \
            & (jb < qlen[:, None])
        is_n = q_is_n | (t_i >= 4)[:, None]
        s_row = jnp.where(is_n, s_n,
                          jnp.where(t_i[:, None] == query, s_match, s_mis))

        hd = st["H_prev"][:, :Q]                            # H(i-1, j-1)
        M = jnp.where(hd > 0, hd + s_row, 0)
        M = jnp.where(in_band, M, 0)

        E = jnp.where(
            i > 0,
            jnp.maximum(jnp.maximum(st["M_prev"] - oe_del, st["E"] - e_del),
                        0),
            st["E"])

        # F via exclusive running max of g = max(M - oe_ins, 0) + j*e_ins
        g = jnp.maximum(M - oe_ins, 0) + jb * e_ins
        cm = jax.lax.cummax(g, axis=1)
        cm_excl = jnp.concatenate([jnp.full((B, 1), NEG), cm[:, :-1]], axis=1)
        F = jnp.maximum(cm_excl - (jb - 1) * e_ins, 0)
        beg = jnp.maximum(i - w, 0)[:, None]
        F = jnp.where(jb > beg, F, 0)

        H = jnp.maximum(jnp.maximum(M, E), F)
        H = jnp.where(in_band, H, 0)

        m = jnp.max(jnp.where(in_band, H, 0), axis=1)
        mj = jnp.max(jnp.where(in_band & (H == m[:, None]), jb, -1), axis=1)

        boundary = jnp.where(
            i <= w, jnp.maximum(h0 - o_del - e_del * (i + 1), 0), 0)
        H_row = jnp.concatenate([boundary[:, None], H], axis=1)

        # gscore update when the band touches the query end
        reach_end = act & (i + w + 1 >= qlen)
        h_last = H_row[rows, qlen]
        g_upd = reach_end & (h_last >= st["gscore"])
        gscore = jnp.where(g_upd, h_last, st["gscore"])
        max_ie = jnp.where(g_upd, i, st["max_ie"])

        # termination + best tracking
        zero_break = act & (m == 0)
        live = act & ~zero_break
        better = live & (m > st["best"])
        best = jnp.where(better, m, st["best"])
        best_i = jnp.where(better, i, st["best_i"])
        best_j = jnp.where(better, mj, st["best_j"])
        max_off = jnp.where(
            better, jnp.maximum(st["max_off"], jnp.abs(mj - i)),
            st["max_off"])
        if zdrop > 0:
            di = i - st["best_i"]
            dj = mj - st["best_j"]
            zcond = jnp.where(
                di > dj,
                st["best"] - m - (di - dj) * e_del > zdrop,
                st["best"] - m - (dj - di) * e_ins > zdrop)
            z_break = live & ~better & zcond
        else:
            z_break = jnp.zeros_like(zero_break)
        alive = st["alive"] & ~zero_break & ~z_break & ((i + 1) < tlen)

        keep = act & ~zero_break & ~z_break
        return dict(
            H_prev=jnp.where(keep[:, None], H_row, st["H_prev"]),
            E=jnp.where(keep[:, None], E, st["E"]),
            M_prev=jnp.where(keep[:, None], M, st["M_prev"]),
            best=best, best_i=best_i, best_j=best_j,
            max_ie=max_ie, gscore=gscore, max_off=max_off,
            alive=alive,
        ), None

    # static-trip scan (dead lanes/rows are masked); the target is
    # transposed once so each row reads its column directly
    st.pop("i")
    st, _ = jax.lax.scan(
        body, st, (jnp.arange(T, dtype=I32), target.T))
    return ExtendBatchResult(
        score=st["best"], qle=st["best_j"] + 1, tle=st["best_i"] + 1,
        gtle=st["max_ie"] + 1, gscore=st["gscore"], max_off=st["max_off"])


extend_batch = jax.jit(
    _extend_core,
    static_argnames=("o_del", "e_del", "o_ins", "e_ins", "zdrop", "mat_max"))


def select_core(platform: str, mesh=None):
    """The extension DP core for a platform, as the ``core`` argument of
    extend_seed_batch and ops.extend_flat: the Hopper kernel
    (ops.extend_cuda) on "gpu", with its lanes split over ``mesh``'s "dp"
    axis when one is given; None, the plain lax.scan core, elsewhere."""
    if platform != "gpu":
        return None
    from tpubwa.ops.extend_cuda import extend_core_cuda

    if mesh is None:
        return extend_core_cuda
    return _lane_sharded(extend_core_cuda, mesh)


@functools.cache
def _lane_sharded(core, mesh):
    """``core`` run per device on its shard of the lanes (a custom call has
    no partitioning rule of its own; the lane count must divide the mesh)."""
    from jax.sharding import PartitionSpec as P

    lane, repl = P("dp"), P()

    def sharded(query, qlen, target, tlen, mat, w, h0, end_bonus, **kw):
        return jax.shard_map(
            functools.partial(core, **kw), mesh=mesh,
            in_specs=(lane, lane, lane, lane, repl, lane, lane, lane),
            out_specs=lane, check_vma=False)(
            query, qlen, target, tlen, mat, w, h0, end_bonus)

    return sharded


class SeedExtResult(NamedTuple):
    left: ExtendBatchResult    # fields are garbage where qlen_l == 0
    right: ExtendBatchResult   # fields are garbage where qlen_r == 0
    score0: jax.Array          # [B] score after the left half (= h0 input
    #                            of the right half)
    aw0: jax.Array             # [B] band actually used on the left
    aw1: jax.Array             # [B] band actually used on the right


@functools.partial(
    jax.jit,
    static_argnames=("o_del", "e_del", "o_ins", "e_ins", "zdrop", "mat_max",
                     "core"))
def extend_seed_batch(q_l, qlen_l, t_l, tlen_l, q_r, qlen_r, t_r, tlen_r,
                      mat, w0, h0, pen5, pen3, *,
                      o_del: int, e_del: int, o_ins: int, e_ins: int,
                      zdrop: int, mat_max: int, core=None) -> SeedExtResult:
    """Whole-seed extension in one device call: left extension (reversed
    sequences), band-doubling retry, then right extension seeded with the
    left score, with its own retry — bwa's per-seed loop in
    mem_chain2aln ([src] bwamem.cpp; SURVEY.md §3.1 worker_aln), fused so
    the host round driver spends one round per *seed* instead of one per
    (side, band try).

    h0: [B] initial score (seed_len * a).  Retry reruns lanes whose
    max_off crossed the bwa threshold with double band (MAX_BAND_TRY=2).
    core: the single-extension core (select_core) — None is the lax.scan
    core.
    """
    import jax.numpy as jnp

    if core is None:
        core = _extend_core
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)

    def side(q, ql, t, tl, h, bonus, prev_score):
        res0 = core(q, ql, t, tl, mat, w0, h, bonus, **kw)
        thresh0 = (w0 >> 1) + (w0 >> 2)
        retry = ((ql > 0) & (res0.score != prev_score)
                 & (res0.max_off >= thresh0))
        ql_retry = jnp.where(retry, ql, 0)
        res1 = core(q, ql_retry, t, tl, mat, 2 * w0, h, bonus, **kw)
        pick = lambda a, b: jnp.where(retry, b, a)  # noqa: E731
        res = ExtendBatchResult(*(pick(a, b) for a, b in zip(res0, res1)))
        aw = jnp.where(retry, 2 * w0, w0)
        return res, aw

    neg1 = jnp.full_like(h0, -1)
    left, aw0 = side(q_l, qlen_l, t_l, tlen_l, h0, pen5, neg1)
    score0 = jnp.where(qlen_l > 0, left.score, h0)
    right, aw1 = side(q_r, qlen_r, t_r, tlen_r, score0, pen3, score0)
    return SeedExtResult(left=left, right=right, score0=score0,
                         aw0=aw0, aw1=aw1)
