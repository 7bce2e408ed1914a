"""The port's register ops against the reference's JAX functions, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is exact (tolerance 0), including the float64 HLL estimates,
which both packages compute with the same numpy code.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.ops import cms as jcms  # noqa: E402
from ruleset_analysis_tpu.ops import counts as jcounts  # noqa: E402
from ruleset_analysis_tpu.ops import hashing as jhash  # noqa: E402
from ruleset_analysis_tpu.ops import hll as jhll  # noqa: E402
from ruleset_analysis_tpu.ops import topk as jtopk  # noqa: E402
from ruleset_analysis_tpu_torch.ops import cms as tcms  # noqa: E402
from ruleset_analysis_tpu_torch.ops import counts as tcounts  # noqa: E402
from ruleset_analysis_tpu_torch.ops import hashing as thash  # noqa: E402
from ruleset_analysis_tpu_torch.ops import hll as thll  # noqa: E402
from ruleset_analysis_tpu_torch.ops import topk as ttopk  # noqa: E402

EDGES = np.array([0, 1, 2, 3, 0xFFFF, 0x10000, 1 << 31, (1 << 31) - 1,
                  (1 << 32) - 2, (1 << 32) - 1], dtype=np.uint32)


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 1 << 32, size=n, dtype=np.uint32)])


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 0x51ED, 0xB5297A4D])
def test_fmix32_and_hash_pair(seed):
    x, y = _u32(4000, 1), _u32(4000, 2)
    np.testing.assert_array_equal(
        _np(thash.fmix32(_t(x), seed=seed)), np.asarray(jhash.fmix32(jnp.asarray(x), seed=seed))
    )
    np.testing.assert_array_equal(
        _np(thash.hash_pair(_t(x), _t(y), seed=seed)),
        np.asarray(jhash.hash_pair(jnp.asarray(x), jnp.asarray(y), seed=seed)),
    )


@pytest.mark.parametrize("bits", [1, 6, 10, 14, 31])
def test_mul_shift_every_constant(bits):
    x = _u32(2000, 3)
    for c in thash.MS_CONSTANTS:
        np.testing.assert_array_equal(
            _np(thash.mul_shift(_t(x), int(c), bits)),
            np.asarray(jhash.mul_shift(jnp.asarray(x), int(c), bits)),
        )


def test_clz32():
    x = np.concatenate([_u32(2000, 4), (np.uint32(1) << np.arange(32, dtype=np.uint32))])
    np.testing.assert_array_equal(
        _np(thash.clz32(_t(x))), np.asarray(jhash.clz32(jnp.asarray(x)))
    )


def test_bits_round_trip():
    x = _u32(1000, 5)
    b = thash.bits_of(_t(x))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy().view(np.uint32), x)
    np.testing.assert_array_equal(_np(thash.u32_of(b)), x)


def test_segment_counts_drops_out_of_range_keys():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 300, size=5000).astype(np.uint32)  # some >= n_keys
    w = rng.integers(0, 2, size=5000).astype(np.uint32)
    np.testing.assert_array_equal(
        _np(tcounts.segment_counts(_t(keys), _t(w), 260)),
        np.asarray(jcounts.segment_counts(jnp.asarray(keys), jnp.asarray(w), 260)),
    )


def test_add64_carries():
    lo = np.array([0xFFFFFFFF, 0xFFFFFFF0, 5, 0], dtype=np.uint32)
    hi = np.array([0, 7, 0xFFFFFFFF, 1], dtype=np.uint32)
    d = np.array([1, 0x20, 3, 0xFFFFFFFF], dtype=np.uint32)
    tl, th = tcounts.add64(_t(lo), _t(hi), _t(d))
    jl, jh = jcounts.add64(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(d))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    assert _np(th)[0] == 1 and _np(tl)[0] == 0  # the carry moved


@pytest.mark.parametrize("width,depth", [(1 << 10, 2), (1 << 14, 4)])
def test_cms_update_and_query(width, depth):
    rng = np.random.default_rng(7)
    keys = _u32(3000, 8)
    w = rng.integers(0, 3, size=keys.shape[0]).astype(np.uint32)
    start = rng.integers(0, 1 << 32, size=(depth, width), dtype=np.uint32)  # wraps
    got = tcms.cms_update(_t(start), _t(keys), _t(w))
    want = jcms.cms_update(jnp.asarray(start), jnp.asarray(keys), jnp.asarray(w))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(tcms.cms_query(got, _t(keys))), np.asarray(jcms.cms_query(want, jnp.asarray(keys)))
    )
    np.testing.assert_array_equal(
        tcms.cms_query_np(_np(got), keys), jcms.cms_query_np(np.asarray(want), keys)
    )


@pytest.mark.parametrize("p", [4, 6, 8])
def test_hll_update_and_estimate(p):
    rng = np.random.default_rng(9)
    n_keys = 40
    keys = rng.integers(0, n_keys + 5, size=6000).astype(np.uint32)  # some dropped
    vals = _u32(6000 - EDGES.size, 10)
    valid = (rng.random(6000) < 0.9).astype(np.uint32)
    start = np.zeros((n_keys, 1 << p), dtype=np.uint32)
    start[3, :] = 2
    got = thll.hll_update(_t(start), _t(keys), _t(vals), _t(valid))
    want = jhll.hll_update(jnp.asarray(start), jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(thll.hll_estimate_np(_np(got)), jhll.hll_estimate_np(np.asarray(want)))


@pytest.mark.parametrize("salt,shift", [(0, 0), (3, 0), (5, 2)])
def test_select_candidates_with_forced_ties(salt, shift):
    """Many pairs with equal in-chunk counts: the tie order must be the
    reference's (lower slot first), since the tracker is capacity-bounded."""
    rng = np.random.default_rng(11)
    n = 3600
    # 600 distinct pairs, each repeated a small equal number of times
    acl = rng.integers(0, 4, size=600).astype(np.uint32)
    src = rng.integers(0, 1 << 32, size=600, dtype=np.uint32)
    rep = np.repeat(np.arange(600), 6)
    rng.shuffle(rep)
    a, s = acl[rep], src[rep]
    valid = (rng.random(n) < 0.95).astype(np.uint32)
    talk = rng.integers(0, 50, size=(2, 1 << 10), dtype=np.uint32)
    got = ttopk.select_candidates(_t(talk), _t(a), _t(s), _t(valid), 64, salt=salt, sample_shift=shift)
    want = jtopk.select_candidates(
        jnp.asarray(talk), jnp.asarray(a), jnp.asarray(s), jnp.asarray(valid), 64,
        salt=salt, sample_shift=shift,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_talker_chunk_update():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 3, size=1000).astype(np.uint32)
    s = rng.integers(0, 40, size=1000).astype(np.uint32)
    v = np.ones(1000, dtype=np.uint32)
    talk = np.zeros((2, 1 << 10), dtype=np.uint32)
    got = ttopk.talker_chunk_update(_t(talk), _t(a), _t(s), _t(v), 16, salt=2)
    want = jtopk.talker_chunk_update(
        jnp.asarray(talk), jnp.asarray(a), jnp.asarray(s), jnp.asarray(v), 16, salt=2
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
