"""Device-mesh parallelism: data-parallel read sharding over the cards.

Replacement for the reference's thread/process scale-out (SURVEY.md §2.2):
``kt_for`` work-sharing over pthreads becomes the batch axis of a
``jax.sharding.Mesh`` — reads are sharded across devices along the "dp"
axis, the FM-index tensors are replicated per device (the reference
equivalent: each EC2 instance holds the full index), and XLA inserts the
(empty, for pure dp) collectives.  The suffix array can be sharded over the
same axis instead (MemOptions.shard_sa, ops.fm.sa_lookup_sharded).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpubwa.ops.extend import extend_batch
from tpubwa.ops.fm import DeviceIndex
from tpubwa.ops.seeds import smems_to_seeds
from tpubwa.ops.smem_chain import collect_smems_chain_fused


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    """Mesh over the first ``n_devices`` of ``devices`` (default: the
    default platform's devices).  Asking for more devices than there are
    is an error."""
    devs = list(jax.devices() if devices is None else devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"a mesh of {n_devices} devices was asked for, but only "
                f"{len(devs)} {devs[0].platform} device(s) are visible")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def default_device():
    """The device that uncommitted arrays land on: the one set by
    jax.default_device when inside it, else the default platform's first."""
    d = jax.config.jax_default_device
    if d is None:
        return jax.devices()[0]
    return jax.devices(d)[0] if isinstance(d, str) else d


@functools.partial(jax.jit, static_argnames=("min_seed_len", "max_occ"))
def device_align_step(di: DeviceIndex, codes: jax.Array, lens: jax.Array,
                      mat: jax.Array, *, min_seed_len: int = 19,
                      max_occ: int = 500):
    """One fused device step: SMEM seeding -> seed expansion -> banded
    extension around the best seed of every read.

    This is the flagship compiled program: all three hot phases (SMEM
    gathers, SA gathers, DP kernel) in one XLA computation.  The host
    pipeline composes the same pieces with host chaining in between.
    """
    B, L = codes.shape
    sm = collect_smems_chain_fused(di, codes.astype(jnp.int32), lens,
                                   min_seed_len=min_seed_len)
    sb = smems_to_seeds(di, sm, max_occ=max_occ, out_seeds=64)

    # pick the longest seed per read and score a right-extension from its
    # end: query suffix vs the reference window following the seed
    slen = jnp.where(sb.valid, sb.len, 0)
    best = jnp.argmax(slen, axis=1)
    rows = jnp.arange(B)
    s_rbeg = sb.rbeg[rows, best]
    s_qbeg = sb.qbeg[rows, best]
    s_len = slen[rows, best]
    has_seed = s_len > 0

    qe = s_qbeg + s_len
    jb = jnp.arange(L, dtype=jnp.int32)[None, :]
    q_right = jnp.take_along_axis(
        codes.astype(jnp.int32),
        jnp.clip(qe[:, None] + jb, 0, L - 1), axis=1)
    qlen_r = jnp.where(has_seed, lens - qe, 0)

    from tpubwa.ops.fm import fetch_ref_batch
    t_pos = (s_rbeg + s_len)[:, None] + jnp.arange(L + 64,
                                                   dtype=jnp.int32)[None, :]
    t_right = fetch_ref_batch(di, t_pos)
    tlen_r = jnp.where(has_seed, jnp.minimum(
        2 * di.l_pac - (s_rbeg + s_len), L + 64), 0)

    ext = extend_batch(
        q_right, qlen_r, t_right, tlen_r, mat,
        jnp.full((B,), 100, jnp.int32),
        jnp.maximum(s_len, 1),
        jnp.full((B,), 5, jnp.int32),
        o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100, mat_max=1)
    return sb.rbeg, sb.qbeg, sb.len, sb.valid, ext.score


def sharded_align_step(mesh: Mesh, di: DeviceIndex, codes: np.ndarray,
                       lens: np.ndarray, mat: np.ndarray):
    """device_align_step with reads sharded over the mesh's dp axis and the
    FM-index replicated on every device."""
    repl = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("dp"))
    di_sharded = jax.device_put(di, repl)
    codes_s = jax.device_put(jnp.asarray(codes, jnp.int32), dp)
    lens_s = jax.device_put(jnp.asarray(lens, jnp.int32), dp)
    mat_s = jax.device_put(jnp.asarray(mat, jnp.int32), repl)
    return device_align_step(di_sharded, codes_s, lens_s, mat_s)
