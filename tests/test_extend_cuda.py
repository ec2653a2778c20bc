"""The Hopper extension kernel (ops/extend_cuda.py, ops/cuda/).

Here on the CPU: the kernel's per-lane DP (ops/cuda/extend_lane.h) is
built for the host and checked, with the wrapper's own operands, against
extend_ref and the plain core, field by field.  The wrapper's shapes and
dtypes and the choice of core are checked too.  The compiled kernel itself
runs under the ``gpu`` marker on a card:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from tpubwa.config import MemOptions
from tpubwa.ops.extend_ref import extend_ref

OPT = MemOptions()
MAT = OPT.score_matrix()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
          e_ins=OPT.e_ins, zdrop=OPT.zdrop, mat_max=OPT.a)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("lane") / "libextlane.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         "-I", os.path.join(ROOT, "tpubwa", "ops", "cuda"), "-o", so,
         os.path.join(ROOT, "tests", "extend_lane_host.cpp")],
        check=True, capture_output=True)
    return ctypes.CDLL(so)


def make_batch(seed: int, B: int, Q: int, T: int, w: int):
    """B lanes of every kind: zero-length, exact, mutated (indels, N),
    unrelated; lengths up to the padded widths."""
    rng = np.random.default_rng(seed)
    q = np.full((B, Q), 4, np.int32)
    t = np.full((B, T), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 4
        tl = int(rng.integers(1, T + 1))
        tt = rng.integers(0, 4, tl)
        if kind == 0:        # exact prefix, to the full width when it fits
            qq = tt[: int(rng.integers(1, min(tl, Q) + 1))]
        elif kind == 1:      # mutated copy: substitutions, indels, N
            src = list(tt[: int(rng.integers(1, min(tl, Q) + 1))])
            qq = []
            for c in src:
                r = rng.random()
                if r < 0.02:
                    continue
                if r < 0.04:
                    qq.append(int(rng.integers(0, 4)))
                qq.append(int(rng.integers(0, 5)) if rng.random() < 0.05
                          else int(c))
            qq = np.array(qq[:Q] or [0])
        elif kind == 2:      # unrelated
            qq = rng.integers(0, 4, int(rng.integers(1, Q + 1)))
        else:                # a few bases off, then a clean tail
            qq = tt[: min(tl, Q)].copy()
            qq[: min(3, len(qq))] = (qq[: min(3, len(qq))] + 1) % 4
        q[b, : len(qq)] = qq
        t[b, :tl] = tt
        qlen[b], tlen[b] = len(qq), tl
    qlen[0] = 0              # zero-length lanes
    tlen[1] = 0
    wv = np.full(B, w, np.int32)
    h0 = rng.integers(1, 40, B).astype(np.int32)
    bonus = np.full(B, 5, np.int32)
    return q, qlen, t, tlen, wv, h0, bonus


def run_host_lanes(lib, args):
    """Run the kernel's lane code on the host over kernel_args operands."""
    query, target, qlen, tlen, w, h0, sc = (np.ascontiguousarray(a)
                                            for a in args)
    B, Q = query.shape
    out = np.zeros((6, B), np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.extend_lanes_host(
        p(query), p(target), p(qlen), p(tlen), p(w), p(h0), p(sc),
        ctypes.c_int64(B), ctypes.c_int32(Q), ctypes.c_int32(target.shape[1]),
        *(ctypes.c_int32(KW[k]) for k in ("o_del", "e_del", "o_ins", "e_ins",
                                          "zdrop")),
        p(out))
    return out


def ref_rows(q, qlen, t, tlen, w, h0, bonus):
    rows = []
    for b in range(len(qlen)):
        r = extend_ref(q[b, : qlen[b]].astype(np.uint8),
                       t[b, : tlen[b]].astype(np.uint8), MAT, OPT.o_del,
                       OPT.e_del, OPT.o_ins, OPT.e_ins, int(w[b]),
                       int(bonus[b]), OPT.zdrop, int(h0[b]))
        rows.append([getattr(r, f) for f in FIELDS])
    return np.array(rows, np.int64).T


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("Q", [32, 160, 256])
@pytest.mark.parametrize("w", [3, 10, 100, 200])
def test_kernel_lanes_match_ref_and_plain_core(lane_lib, w, Q, x64):
    """B=37 lanes (not a multiple of the 32-lane block) with zero-length
    lanes: the kernel's lane DP, fed the wrapper's operands, equals
    extend_ref and the plain lax.scan core on every field."""
    import jax
    import jax.numpy as jnp

    from tpubwa.ops.extend import _extend_core
    from tpubwa.ops.extend_cuda import kernel_args

    T = Q + 24
    batch = make_batch(1000 * w + Q, 37, Q, T, w)
    q, qlen, t, tlen, wv, h0, bonus = batch
    want = ref_rows(*batch)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        dev = [jnp.asarray(a) for a in (q, qlen, t, tlen)]
        args = kernel_args(dev[0], dev[1], dev[2], dev[3], jnp.asarray(MAT),
                           jnp.asarray(wv), jnp.asarray(h0),
                           jnp.asarray(bonus), **{k: KW[k] for k in (
                               "o_del", "e_del", "o_ins", "e_ins",
                               "mat_max")})
        assert [a.dtype for a in args] == [jnp.int8, jnp.int8] + \
            [jnp.int32] * 5
        plain = jax.jit(_extend_core, static_argnames=tuple(KW))(
            dev[0], dev[1], dev[2], dev[3], jnp.asarray(MAT),
            jnp.asarray(wv), jnp.asarray(h0), jnp.asarray(bonus), **KW)
        plain = np.stack([np.asarray(x) for x in plain])
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = run_host_lanes(lane_lib, [np.asarray(a) for a in args])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


def test_kernel_args_shapes_and_band_clamp():
    """The operands keep the lane order and widths; the band arrives
    clamped exactly as the plain core clamps it; the scores are the
    matrix's (match, mismatch, N) values."""
    import jax.numpy as jnp

    from tpubwa.ops.extend import clamp_band_batch
    from tpubwa.ops.extend_cuda import kernel_args

    q, qlen, t, tlen, wv, h0, bonus = make_batch(7, 45, 48, 80, 200)
    args = kernel_args(*(jnp.asarray(a) for a in (q, qlen, t, tlen, MAT,
                                                   wv, h0, bonus)),
                       **{k: KW[k] for k in ("o_del", "e_del", "o_ins",
                                             "e_ins", "mat_max")})
    query, target, ql, tl, w, hh, sc = (np.asarray(a) for a in args)
    assert query.shape == (45, 48) and target.shape == (45, 80)
    np.testing.assert_array_equal(query, q)
    np.testing.assert_array_equal(target, t)
    np.testing.assert_array_equal(ql, qlen)
    np.testing.assert_array_equal(tl, tlen)
    np.testing.assert_array_equal(hh, h0)
    want_w = clamp_band_batch(jnp.asarray(wv), jnp.asarray(qlen), OPT.a,
                              OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins,
                              jnp.asarray(bonus))
    np.testing.assert_array_equal(w, np.asarray(want_w))
    assert (w < 200).any() and (w >= 1).all()
    assert sc.tolist() == [OPT.a, -OPT.b, -1]


def test_select_core():
    """One function picks the core: the kernel on the GPU (without
    building it), the plain core (None) elsewhere; a mesh gets one cached
    lane-sharded wrapper."""
    from tpubwa.ops.extend import select_core
    from tpubwa.ops.extend_cuda import extend_core_cuda
    from tpubwa.parallel.mesh import make_mesh

    assert select_core("cpu") is None
    assert select_core("gpu") is extend_core_cuda
    mesh = make_mesh(4)
    sharded = select_core("gpu", mesh=mesh)
    assert sharded is not extend_core_cuda
    assert select_core("gpu", mesh=mesh) is sharded


@pytest.mark.gpu
def test_cuda_kernel_on_card(gpu):
    """The compiled kernel at real widths equals extend_ref and the plain
    core: 4096 full-match lanes at Q=T=256, and mixed lanes at Q=160."""
    import jax
    import jax.numpy as jnp

    from tpubwa.ops.extend import _extend_core
    from tpubwa.ops.extend_cuda import extend_core_cuda

    def run(core, batch):
        q, qlen, t, tlen, wv, h0, bonus = (jnp.asarray(a) for a in batch)
        out = jax.jit(core, static_argnames=tuple(KW))(
            q, qlen, t, tlen, jnp.asarray(MAT), wv, h0, bonus, **KW)
        return np.stack([np.asarray(x) for x in out])

    rng = np.random.default_rng(0)
    full_q = rng.integers(0, 4, (4096, 256)).astype(np.int32)
    full = (full_q, np.full(4096, 256, np.int32), full_q.copy(),
            np.full(4096, 256, np.int32), np.full(4096, 100, np.int32),
            np.full(4096, 30, np.int32), np.full(4096, 5, np.int32))
    mixed = make_batch(11, 4099, 160, 768, 100)
    for batch in (full, mixed):
        got = run(extend_core_cuda, batch)
        np.testing.assert_array_equal(got, run(_extend_core, batch))
        sample = np.arange(0, len(batch[1]), 64)
        sub = tuple(a[sample] for a in batch)
        np.testing.assert_array_equal(got[:, sample], ref_rows(*sub))
