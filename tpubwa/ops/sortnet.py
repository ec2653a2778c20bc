"""Row-wise bitonic sorting network.

A bitonic network over a power-of-two row width is plain elementwise
work: ~W/2 * log^2(W) compare-exchanges with static permutations, in
place of XLA's generic sort (which was slow on the first target; whether
lax.sort does better on the GPU is not measured).  Used for the per-read
SMEM / seed slot buffers (W = 32..128).

Not stable — callers must ensure equal keys carry identical payloads (true
for SMEM dedup entries) or disambiguate keys.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _stages(w: int):
    """Precompute (partner, dir_up) index arrays per stage for width w."""
    import numpy as np

    assert w & (w - 1) == 0, "width must be a power of two"
    ids = np.arange(w)
    stages = []
    k = 2
    while k <= w:
        j = k >> 1
        while j >= 1:
            partner = ids ^ j
            up = ((ids & k) == 0)
            stages.append((tuple(partner.tolist()), tuple(up.tolist())))
            j >>= 1
        k <<= 1
    return stages


def bitonic_argsort(keys: jnp.ndarray) -> jnp.ndarray:
    """Ascending argsort along the last axis (power-of-two width).

    keys: [..., W] int32/int64.  Returns int32 permutation [..., W]."""
    w = keys.shape[-1]
    idx = jnp.broadcast_to(
        jnp.arange(w, dtype=jnp.int32), keys.shape).astype(jnp.int32)
    for partner, up in _stages(w):
        p = jnp.asarray(partner, dtype=jnp.int32)
        u = jnp.asarray(up, dtype=bool)
        pk = keys[..., p]
        pi = idx[..., p]
        is_lo = jnp.arange(w) < p          # this element is the lower index
        keep = jnp.where(
            is_lo ^ ~u,                     # ascending half: lo keeps min
            (keys <= pk), (keys >= pk))
        keys = jnp.where(keep, keys, pk)
        idx = jnp.where(keep, idx, pi)
    return idx


def bitonic_sort_rows(keys: jnp.ndarray, *payloads: jnp.ndarray):
    """Sort keys ascending along the last axis, permuting payloads along."""
    order = bitonic_argsort(keys)
    out = [jnp.take_along_axis(keys, order, axis=-1)]
    for p in payloads:
        out.append(jnp.take_along_axis(p, order, axis=-1))
    return tuple(out)
