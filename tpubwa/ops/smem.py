"""Shared SMEM data structures and small batched helpers (JAX).

Batched re-expression of the reference's seeding engine (SURVEY.md §3.1:
worker_bwt → mem_collect_intv → bwt_smem1 → backward-search loop, [src]
FMI_search.cpp:599-760): instead of per-read scalar loops with software
prefetch, every read in a (B,)-batch advances in lockstep through masked
``lax.while_loop`` steps, and every interval extension in flight becomes one
row of a batched occ-checkpoint gather (ops.fm.occ4).  Irregular per-read
control flow (variable SMEM counts, early breaks) is handled with validity
masks over fixed-shape buffers — SURVEY.md §7 "irregular control flow on a
SIMD machine".

Semantics are defined by the scalar reference (tpubwa.ops.fm_ref); tests
assert exact equality.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpubwa.ops.fm import BiInterval, DeviceIndex, backward_ext_all, set_intv

I32 = jnp.int32
BIG = jnp.int32(1 << 30)


class Smems(NamedTuple):
    """Fixed-shape SMEM buffers: [B, M] int32 each + count/overflow [B]."""

    k: jax.Array
    l: jax.Array
    s: jax.Array
    start: jax.Array
    end: jax.Array
    n: jax.Array
    overflow: jax.Array


def _take_q(q: jax.Array, i: jax.Array) -> jax.Array:
    """q: [B, L]; i: [B] -> q[b, clip(i)] (out-of-range returns 4)."""
    L = q.shape[1]
    qi = jnp.take_along_axis(q, jnp.clip(i, 0, L - 1)[:, None], axis=1)[:, 0]
    return jnp.where((i >= 0) & (i < L), qi, 4)


def _pick_base(arr4: jax.Array, c: jax.Array) -> jax.Array:
    """arr4: [..., 4]; c: [...] -> arr4[..., c].  Mask-sum instead of a
    gather over the 4-wide minor dim."""
    ids = jnp.arange(4, dtype=jnp.int32)
    sel = ids == jnp.clip(c, 0, 3)[..., None]
    return jnp.sum(jnp.where(sel, arr4, 0), axis=-1)


def _append(arrs, n, vals, mask, cap):
    """Write vals at per-row slot n where mask; bump n.  Returns
    (new_arrs, new_n, dropped_mask)."""
    rows = jnp.arange(n.shape[0])
    ok = mask & (n < cap)
    slot = jnp.minimum(n, cap - 1)
    out = []
    for a, v in zip(arrs, vals):
        cur = a[rows, slot]
        out.append(a.at[rows, slot].set(jnp.where(ok, v, cur)))
    return tuple(out), n + ok.astype(I32), mask & (n >= cap)
