"""seed_rows (fused global-layout expansion) vs the padded reference path
(smems_to_seeds + compact_seeds): row-for-row equality.

The old path is kept as the correctness reference; the fused path is what
the pipeline runs (one scatter+cummax owner map instead of an O(B*M*S)
compare, no padded intermediate).
"""
import numpy as np
import pytest

from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig


@pytest.fixture(scope="module")
def idx():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 4000).astype(np.uint8)
    return FMIndex.build([Contig("c1", 4000, 0)], codes)


def _random_smems(rng, di, B, M):
    """Random but structurally valid Smems: intervals within SA bounds,
    starts ascending per read (as the chain engine emits them)."""
    import jax.numpy as jnp

    from tpubwa.ops.smem import Smems

    N = int(di.sa.shape[0]) - 1
    n = rng.integers(0, M + 1, B).astype(np.int32)
    k = np.zeros((B, M), np.int32)
    s = np.zeros((B, M), np.int32)
    start = np.zeros((B, M), np.int32)
    end = np.zeros((B, M), np.int32)
    for b in range(B):
        st = 0
        for m in range(int(n[b])):
            occ = int(rng.integers(1, 40)) if rng.random() < 0.9 \
                else int(rng.integers(1, 2000))
            occ = min(occ, N - 1)
            k[b, m] = rng.integers(0, N - occ)
            s[b, m] = occ
            st += int(rng.integers(0, 10))
            ln = int(rng.integers(19, 40))
            start[b, m] = st
            end[b, m] = st + ln
            st += 1
    z = jnp.asarray
    return Smems(k=z(k), l=z(k), s=z(s), start=z(start), end=z(end),
                 n=z(n), overflow=jnp.zeros(B, bool))


@pytest.mark.parametrize("B,M,max_occ,cap", [
    (8, 16, 10, 64), (16, 8, 500, 128), (4, 16, 5, 8),
])
def test_seed_rows_matches_reference(idx, B, M, max_occ, cap):
    import jax.numpy as jnp

    from tpubwa.ops.fm import DeviceIndex
    from tpubwa.ops.seeds import compact_seeds, seed_rows, smems_to_seeds

    rng = np.random.default_rng(B * 1000 + M)
    di = DeviceIndex.from_host(idx)
    sm = _random_smems(rng, di, B, M)

    ref = compact_seeds(smems_to_seeds(di, sm, max_occ=max_occ,
                                       out_seeds=cap))
    got = seed_rows(di, sm, max_occ=max_occ, per_read_cap=cap)
    n_ref, n_got = int(ref.n), int(got.n)
    assert n_got == n_ref
    np.testing.assert_array_equal(np.asarray(got.packed)[:n_got],
                                  np.asarray(ref.packed)[:n_ref])
    np.testing.assert_array_equal(np.asarray(got.l_rep),
                                  np.asarray(ref.l_rep))
    np.testing.assert_array_equal(np.asarray(got.overflow),
                                  np.asarray(ref.overflow))


def test_seed_rows_global_cap_flags_overflow(idx):
    import jax.numpy as jnp

    from tpubwa.ops.fm import DeviceIndex
    from tpubwa.ops.seeds import seed_rows

    rng = np.random.default_rng(3)
    di = DeviceIndex.from_host(idx)
    sm = _random_smems(rng, di, 8, 16)
    full = seed_rows(di, sm, max_occ=500, per_read_cap=128)
    tight = seed_rows(di, sm, max_occ=500, per_read_cap=2)
    # the per-read cap is the only truncation: an over-cap read is flagged
    # and keeps a prefix of at most 2 of its seeds (strand-bridging rows
    # drop after the cap); reads under the cap keep all of theirs
    ovf = np.asarray(tight.overflow)
    assert ovf.any()
    rows_full = np.asarray(full.packed)[:int(full.n)]
    rows_tight = np.asarray(tight.packed)[:int(tight.n)]
    for b in range(8):
        mine = rows_full[rows_full[:, 0] == b]
        kept = rows_tight[rows_tight[:, 0] == b]
        assert len(kept) <= 2
        np.testing.assert_array_equal(kept, mine[:len(kept)])
        if not ovf[b]:
            np.testing.assert_array_equal(kept, mine)
        if len(mine) > 2:
            assert ovf[b]
