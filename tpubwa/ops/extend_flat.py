"""Flat whole-seed extension: job descriptors in, DP results out, with the
query/target windows gathered ON DEVICE.

The batched replacement for the per-seed lockstep rounds of
align/region.py run_extension_rounds (reference analog: the batched SoA
wrappers feeding bandedSWA, SURVEY.md §2.1/§3.1 HOT LOOP #1): the native
host engine (native/extension.cpp) emits one descriptor per chain seed —
(read_id, qbeg, slen, rbeg, rmax0, rmax1, h0), ~7 scalars — and this module
builds the four (query, target) buffers with gathers from the device-
resident read batch and 2-bit packed reference, then runs the fused
left+right band-doubling extension (ops.extend.extend_seed_batch).

Shipping descriptors instead of sequences cuts host->device traffic ~500x
(the round driver uploaded ~2K int32 of sequence per job; a descriptor is
7), and the whole batch extends in ceil(J / wave) device calls instead of
max-seeds-per-read lockstep rounds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpubwa.ops.extend import extend_seed_batch
from tpubwa.ops.fm import (DeviceIndex, ref_window_left, ref_window_right)

I32 = jnp.int32

# static (query, target) pad widths — match the round driver's buffers so
# truncation behavior (and therefore output) is identical: q_pad=192,
# t_pad=768 (align/region.py run_extension_rounds defaults)
Q_PAD = 192
T_PAD = 768


@functools.partial(jax.jit, static_argnames=(
    "o_del", "e_del", "o_ins", "e_ins", "zdrop", "mat_max", "w0",
    "pen_clip5", "pen_clip3", "q_pad", "t_pad", "core"))
def extend_jobs(di: DeviceIndex, codes: jax.Array, lens: jax.Array,
                rd: jax.Array, qbeg: jax.Array, slen: jax.Array,
                rbeg: jax.Array, rmax0: jax.Array, rmax1: jax.Array,
                h0: jax.Array, mat: jax.Array, *,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                zdrop: int, mat_max: int, w0: int, pen_clip5: int,
                pen_clip3: int, q_pad: int = Q_PAD, t_pad: int = T_PAD,
                core=None) -> jax.Array:
    """Extend J seed jobs; returns int32 [14, J] result rows
    (left score,qle,tle,gtle,gscore,max_off; right same; aw0; aw1 —
    the order native/extension.cpp ext_finalize consumes).

    codes: [B, L] int32 device read batch (4 = pad); lens: [B] int32.
    rd/qbeg/slen/rbeg/rmax0/rmax1/h0: [J] int32 job descriptors (padding
    jobs: rd=0, slen=0, qbeg=0, rbeg=rmax0=rmax1=0 — results are garbage
    and ignored by the host replay).
    """
    L = codes.shape[1]
    J = rd.shape[0]
    codes = codes.astype(I32)
    qg = codes[rd]                                    # [J, L] row gather
    jq = jnp.arange(q_pad, dtype=I32)[None, :]        # [1, Qp]
    jt = jnp.arange(t_pad, dtype=I32)[None, :]        # [1, Tp]

    # left: query[0:qbeg] reversed; ref[rmax0:rbeg] reversed
    qlen_l = jnp.minimum(qbeg, q_pad)
    qidx_l = qbeg[:, None] - 1 - jq
    q_l = jnp.take_along_axis(qg, jnp.clip(qidx_l, 0, L - 1), axis=1)
    q_l = jnp.where(jq < qlen_l[:, None], q_l, 4)
    # window lengths fit int32 regardless of the (possibly int64) rbeg
    tlen_l = jnp.minimum(rbeg - rmax0, t_pad).astype(I32)
    t_l = ref_window_left(di, rbeg, t_pad)   # word-gather, 1/16th elements
    t_l = jnp.where(jt < tlen_l[:, None], t_l, 4)

    # right: query[qe:l_query]; ref[rbeg+slen : rmax1]
    qe = qbeg + slen
    qlen_r = jnp.minimum(lens[rd] - qe, q_pad)
    qidx_r = qe[:, None] + jq
    q_r = jnp.take_along_axis(qg, jnp.clip(qidx_r, 0, L - 1), axis=1)
    q_r = jnp.where(jq < qlen_r[:, None], q_r, 4)
    re0 = rbeg + slen
    tlen_r = jnp.minimum(rmax1 - re0, t_pad).astype(I32)
    t_r = ref_window_right(di, re0, t_pad)
    t_r = jnp.where(jt < tlen_r[:, None], t_r, 4)

    w0v = jnp.full((J,), w0, I32)
    pen5 = jnp.full((J,), pen_clip5, I32)
    pen3 = jnp.full((J,), pen_clip3, I32)
    out = extend_seed_batch(
        q_l, qlen_l, t_l, jnp.maximum(tlen_l, 0),
        q_r, jnp.maximum(qlen_r, 0), t_r, jnp.maximum(tlen_r, 0),
        mat, w0v, jnp.maximum(h0, 1), pen5, pen3,
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        zdrop=zdrop, mat_max=mat_max, core=core)
    res = jnp.stack(list(out.left) + list(out.right) + [out.aw0, out.aw1])
    # every field is bounded by +-(mat_max * (L + window)) (scores) or the
    # window sizes (positions/offsets); when that bound fits int16, download
    # half the bytes (host casts back to int32)
    if mat_max * (L + q_pad + t_pad) < 32000:
        res = res.astype(jnp.int16)
    return res


@functools.partial(jax.jit, static_argnames=(
    "o_del", "e_del", "o_ins", "e_ins", "zdrop", "mat_max", "w0",
    "pen_clip5", "q_pad", "t_pad", "core"))
def extend_jobs_left(di: DeviceIndex, codes: jax.Array, lens: jax.Array,
                     rd: jax.Array, qbeg: jax.Array, rbeg: jax.Array,
                     rmax0: jax.Array, h0: jax.Array, mat: jax.Array, *,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, mat_max: int, w0: int, pen_clip5: int,
                     q_pad: int = Q_PAD, t_pad: int = T_PAD,
                     core=None) -> jax.Array:
    """LEFT half of extend_jobs as its own program: returns int32|int16
    [8, J] = (score,qle,tle,gtle,gscore,max_off,aw0,score0).

    Split so run_waves can sort the left and right lane streams by their
    OWN effective depths (a lane with a deep right window no longer drags
    its shallow left tile to the joint max — measured 1.4x fewer
    tile-rows on the bench workload)."""
    from tpubwa.ops.extend import _extend_core, ExtendBatchResult

    if core is None:
        core = _extend_core
    L = codes.shape[1]
    codes = codes.astype(I32)
    qg = codes[rd]
    jq = jnp.arange(q_pad, dtype=I32)[None, :]
    jt = jnp.arange(t_pad, dtype=I32)[None, :]
    qlen_l = jnp.minimum(qbeg, q_pad)
    qidx_l = qbeg[:, None] - 1 - jq
    q_l = jnp.take_along_axis(qg, jnp.clip(qidx_l, 0, L - 1), axis=1)
    q_l = jnp.where(jq < qlen_l[:, None], q_l, 4)
    tlen_l = jnp.minimum(rbeg - rmax0, t_pad).astype(I32)
    t_l = ref_window_left(di, rbeg, t_pad)
    t_l = jnp.where(jt < tlen_l[:, None], t_l, 4)

    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    h0v = jnp.maximum(h0, 1).astype(I32)
    pen5 = jnp.full(rd.shape, pen_clip5, I32)
    w0v = jnp.full(rd.shape, w0, I32)
    qlen_l = qlen_l.astype(I32)
    tlen_l = jnp.maximum(tlen_l, 0)
    res0 = core(q_l, qlen_l, t_l, tlen_l, mat, w0v, h0v, pen5, **kw)
    thresh0 = (w0 >> 1) + (w0 >> 2)
    neg1 = jnp.full(rd.shape, -1, I32)
    retry = ((qlen_l > 0) & (res0.score != neg1)
             & (res0.max_off >= thresh0))
    ql_retry = jnp.where(retry, qlen_l, 0)
    res1 = core(q_l, ql_retry, t_l, tlen_l, mat, 2 * w0v, h0v, pen5, **kw)
    pick = lambda a, b: jnp.where(retry, b, a)  # noqa: E731
    left = ExtendBatchResult(*(pick(a, b) for a, b in zip(res0, res1)))
    aw0 = jnp.where(retry, 2 * w0v, w0v)
    score0 = jnp.where(qlen_l > 0, left.score, h0v)
    res = jnp.stack(list(left) + [aw0, score0])
    if mat_max * (L + q_pad + t_pad) < 32000:
        res = res.astype(jnp.int16)
    return res


@functools.partial(jax.jit, static_argnames=(
    "o_del", "e_del", "o_ins", "e_ins", "zdrop", "mat_max", "w0",
    "pen_clip3", "q_pad", "t_pad", "core"))
def extend_jobs_right(di: DeviceIndex, codes: jax.Array, lens: jax.Array,
                      rd: jax.Array, qbeg: jax.Array, slen: jax.Array,
                      rbeg: jax.Array, rmax1: jax.Array,
                      score0: jax.Array, mat: jax.Array, *,
                      o_del: int, e_del: int, o_ins: int, e_ins: int,
                      zdrop: int, mat_max: int, w0: int, pen_clip3: int,
                      q_pad: int = Q_PAD, t_pad: int = T_PAD,
                      core=None) -> jax.Array:
    """RIGHT half of extend_jobs (seeded with the left pass's score0):
    int32|int16 [7, J] = (score,qle,tle,gtle,gscore,max_off,aw1)."""
    from tpubwa.ops.extend import _extend_core, ExtendBatchResult

    if core is None:
        core = _extend_core
    L = codes.shape[1]
    codes = codes.astype(I32)
    qg = codes[rd]
    jq = jnp.arange(q_pad, dtype=I32)[None, :]
    jt = jnp.arange(t_pad, dtype=I32)[None, :]
    qe = qbeg + slen
    qlen_r = jnp.minimum(lens[rd] - qe, q_pad).astype(I32)
    qidx_r = qe[:, None] + jq
    q_r = jnp.take_along_axis(qg, jnp.clip(qidx_r, 0, L - 1), axis=1)
    q_r = jnp.where(jq < qlen_r[:, None], q_r, 4)
    re0 = rbeg + slen
    tlen_r = jnp.minimum(rmax1 - re0, t_pad).astype(I32)
    t_r = ref_window_right(di, re0, t_pad)
    t_r = jnp.where(jt < tlen_r[:, None], t_r, 4)

    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    sc0 = score0.astype(I32)
    pen3 = jnp.full(rd.shape, pen_clip3, I32)
    w0v = jnp.full(rd.shape, w0, I32)
    qlen_r = jnp.maximum(qlen_r, 0)
    tlen_r = jnp.maximum(tlen_r, 0)
    res0 = core(q_r, qlen_r, t_r, tlen_r, mat, w0v, sc0, pen3, **kw)
    thresh0 = (w0 >> 1) + (w0 >> 2)
    retry = ((qlen_r > 0) & (res0.score != sc0)
             & (res0.max_off >= thresh0))
    ql_retry = jnp.where(retry, qlen_r, 0)
    res1 = core(q_r, ql_retry, t_r, tlen_r, mat, 2 * w0v, sc0, pen3, **kw)
    pick = lambda a, b: jnp.where(retry, b, a)  # noqa: E731
    right = ExtendBatchResult(*(pick(a, b) for a, b in zip(res0, res1)))
    aw1 = jnp.where(retry, 2 * w0v, w0v)
    res = jnp.stack(list(right) + [aw1])
    if mat_max * (L + q_pad + t_pad) < 32000:
        res = res.astype(jnp.int16)
    return res
