"""The port's register tail against the reference's formulations, op by op.

Mirrors the op-level half of tests/test_sorted_update.py on the port.
The port has one register tail (``ops/reg_tail.py``: the reg_tail kernel
on the card, its plain version here); the reference has three
formulations of it (scatter, ``ops/sorted_update.py``'s sorted segment
reduces, the matmul and reduce counts of ``ops/counts.py``), equal by
construction.  Each of them is held to the port's tail on seeded
adversarial inputs: out-of-range keys, zero and large weights, slot
collisions; and deferred selection (``topk_every``).  A numpy model of
csrc/reg_tail.cu's per-line arithmetic, fed only the constants the
wrapper passes to the kernel, pins those constants and the kernel's
hashing to the reference.  Then the step: every flag combination the
reference accepts, chunk by chunk, against the reference's
``pipeline.analysis_step`` under the same flags.  Tolerance 0.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.hostside import synth as rsynth  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as jpipe  # noqa: E402
from ruleset_analysis_tpu.ops import counts as jcounts  # noqa: E402
from ruleset_analysis_tpu.ops import hashing as jhashing  # noqa: E402
from ruleset_analysis_tpu.ops import hll as jhll  # noqa: E402
from ruleset_analysis_tpu.ops import match6 as jmatch6  # noqa: E402
from ruleset_analysis_tpu.ops import sorted_update as jsorted  # noqa: E402
from ruleset_analysis_tpu.ops import topk as jtopk  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import synth  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import cms as tcms  # noqa: E402
from ruleset_analysis_tpu_torch.ops import counts as tcounts  # noqa: E402
from ruleset_analysis_tpu_torch.ops import hll as thll  # noqa: E402
from ruleset_analysis_tpu_torch.ops import reg_tail  # noqa: E402
from ruleset_analysis_tpu_torch.ops import topk as ttopk  # noqa: E402
from ruleset_analysis_tpu_torch.ops.hashing import hash_pair  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _b(a) -> torch.Tensor:
    """u32 values -> the int32 bit column the tail takes."""
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.uint32).view(np.int32).copy())


def _np(x) -> np.ndarray:
    return x.numpy().astype(np.uint32) if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(seed: int, b: int, n_keys: int, *, w_hi: int = 5, src_hi: int = 2**32):
    """Keys with out-of-range ones, weights with zeros, sources, acls."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys + 7, b).astype(np.uint32)
    w = rng.integers(0, w_hi, b).astype(np.uint32)
    src = rng.integers(0, src_hi, b, dtype=np.uint64).astype(np.uint32)
    acl = rng.integers(0, 6, b).astype(np.uint32)
    return keys, w, src, acl


def _key_rows(keys):
    """(row, key_k, n_rows): match rows and a key table that maps row r to
    key r, so the tail sees ``keys`` (0xFFFFFFFF: no match, onto a deny key
    that is no key)."""
    keys = np.asarray(keys, np.uint32)
    n_rows = int(keys[keys != 0xFFFFFFFF].max(initial=0)) + 1
    key_k = _b(np.append(np.arange(n_rows, dtype=np.uint32), 0xFFFFFFFF))
    return _b(keys), key_k, n_rows


def port_tail(talk, hll, keys, w, src, acl, **kw):
    """The port's tail (the plain version, on CPU tensors) over per-line keys."""
    row, key_k, n_rows = _key_rows(keys)
    return reg_tail.reg_tail(talk, hll, row, _b(w), _b(acl), (_b(src),), key_k, n_rows=n_rows,
                             **kw)


def _talk(depth=2, width=1 << 10):
    return torch.zeros((depth, width), dtype=torch.int64)


# --- the reference's sorted segment reduces -----------------------------------


@pytest.mark.parametrize("need_counts", [True, False])
def test_counts_hll_sorted_equals_scatter_and_reference(need_counts):
    b, n_keys, p = 1500, 37, 4
    keys, w, src, acl = _inputs(0, b, n_keys)
    hll0 = np.random.default_rng(1).integers(0, 3, (n_keys, 1 << p)).astype(np.uint32)
    hll = _t(hll0)
    delta, _, _ = port_tail(_talk(), hll, keys, w, src, acl, counts=need_counts, select=False)
    want_hll = thll.hll_update(_t(hll0), _t(keys), _t(src), _t(w))
    jdelta, jhll_new = jsorted.counts_hll_sorted(
        jnp.asarray(hll0), jnp.asarray(keys), jnp.asarray(w), jnp.asarray(src), n_keys,
        need_counts=need_counts)
    np.testing.assert_array_equal(_np(hll), _np(want_hll))
    np.testing.assert_array_equal(_np(hll), np.asarray(jhll_new))
    if need_counts:
        np.testing.assert_array_equal(_np(delta), _np(tcounts.segment_counts(_t(keys), _t(w),
                                                                             n_keys)))
        np.testing.assert_array_equal(_np(delta), np.asarray(jdelta))
    else:
        assert delta is None and jdelta is None


@pytest.mark.parametrize("with_candidates", [True, False])
@pytest.mark.parametrize("shift", [0, 2])
def test_talker_tables_sorted_equal_scatter_and_reference(shift, with_candidates):
    b, width, depth, slots, salt = 2003, 1 << 10, 2, ttopk.CAND_SLOTS, 5
    keys, w, src, acl = _inputs(2, b, 8, w_hi=4, src_hi=50)  # few sources: collisions
    talk0 = np.random.default_rng(3).integers(0, 9, (depth, width)).astype(np.uint32)
    talk = _t(talk0)
    _, cnt, rep = port_tail(talk, torch.zeros((8, 16), dtype=torch.int64), keys, w, src, acl,
                            counts=False, salt=salt, sample_shift=shift, select=with_candidates,
                            slots=slots)
    want_cms = tcms.cms_update(_t(talk0), hash_pair(_t(acl), _t(src)), _t(w))
    np.testing.assert_array_equal(_np(talk), _np(want_cms))
    jcd, jcnt, jrep = jsorted.talker_tables_sorted(
        jnp.asarray(acl), jnp.asarray(src), jnp.asarray(w), jnp.uint32(salt), width=width,
        depth=depth, slots=slots, sample_shift=shift, with_candidates=with_candidates)
    np.testing.assert_array_equal(_np(talk), (np.asarray(jcd).astype(np.uint64) + talk0) % 2**32)
    if with_candidates:
        np.testing.assert_array_equal(_np(cnt), np.asarray(jcnt))
        np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep).astype(np.int64))
        wcnt, wrep = ttopk.candidate_tables(_t(acl), _t(src), _t(w), salt, slots, shift)
        assert torch.equal(cnt, wcnt) and torch.equal(rep, wrep)
    else:
        assert cnt is None and rep is None
        assert int(np.asarray(jcnt).sum()) == 0 and bool((np.asarray(jrep) == -1).all())


def test_composite_overflow_falls_back_value_identically(monkeypatch):
    """The reference's sorted counts take their scatter fallback when the
    ``key*m + reg`` composite would overflow; both branches equal the
    port's tail."""
    assert jsorted.composite_fits(1 << 20, 256)
    assert not jsorted.composite_fits(1 << 24, 256)
    b, n_keys, p = 600, 19, 3
    keys, w, src, acl = _inputs(4, b, n_keys, w_hi=3)
    hll = torch.zeros((n_keys, 1 << p), dtype=torch.int64)
    delta, _, _ = port_tail(_talk(), hll, keys, w, src, acl, counts=True, select=False)
    args = (jnp.zeros((n_keys, 1 << p), jnp.uint32), jnp.asarray(keys), jnp.asarray(w),
            jnp.asarray(src), n_keys)
    want = jsorted.counts_hll_sorted(*args, need_counts=True)
    monkeypatch.setattr(jsorted, "COMPOSITE_LIMIT", 4)  # force the fallback
    assert not jsorted.composite_fits(n_keys, 1 << p)
    fallback = jsorted.counts_hll_sorted(*args, need_counts=True)
    for got_d, got_h in (want, fallback):
        np.testing.assert_array_equal(_np(delta), np.asarray(got_d))
        np.testing.assert_array_equal(_np(hll), np.asarray(got_h))


def test_sorted_drops_every_out_of_range_key():
    """A batch whose keys are all out of range changes no register, in the
    port's tail and in the reference's sorted counts."""
    n_keys, p = 11, 5
    keys = np.full(300, n_keys + 3, np.uint32)
    keys[::7] = 0xFFFFFFFF
    _, w, src, acl = _inputs(5, 300, n_keys)
    hll = torch.zeros((n_keys, 1 << p), dtype=torch.int64)
    delta, _, _ = port_tail(_talk(), hll, keys, w, src, acl, counts=True, select=False)
    assert int(delta.sum()) == 0 and int(hll.sum()) == 0
    jdelta, jhll_new = jsorted.counts_hll_sorted(
        jnp.zeros((n_keys, 1 << p), jnp.uint32), jnp.asarray(keys), jnp.asarray(w),
        jnp.asarray(src), n_keys, need_counts=True)
    assert int(np.asarray(jdelta).sum()) == 0 and int(np.asarray(jhll_new).sum()) == 0


# --- the reference's counts formulations --------------------------------------


@pytest.mark.parametrize("block", ["default", "tiny"])
@pytest.mark.parametrize("impl", ["scatter", "matmul", "reduce"])
def test_segment_counts_formulations_equal_reference(impl, block):
    """Every reference formulation equals the port's tail's counts delta, on
    a batch of 3001 lines and on one of 64."""
    b, n_keys = (3001 if block == "default" else 64), 29
    keys, w, src, acl = _inputs(6, b, n_keys, w_hi=2000)
    got, _, _ = port_tail(_talk(), torch.zeros((n_keys, 16), dtype=torch.int64), keys, w, src,
                          acl, counts=True, select=False)
    want = jcounts.SEGMENT_COUNTS_IMPLS[impl](jnp.asarray(keys), jnp.asarray(w), n_keys)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), _np(tcounts.segment_counts(_t(keys), _t(w), n_keys)))


def test_reduce_counts_wrap_like_u32():
    """Per-key sums past 2^32 wrap, in the port's tail as in the reference's
    reduce formulation."""
    keys = np.zeros(4, np.uint32)
    w = np.full(4, 0xC0000000, np.uint32)
    got, _, _ = port_tail(_talk(), torch.zeros((3, 16), dtype=torch.int64), keys, w, keys,
                          keys, counts=True, select=False)
    want = jcounts.segment_counts_reduce(jnp.asarray(keys), jnp.asarray(w), 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --- deferred selection -------------------------------------------------------


@pytest.mark.parametrize("k,b,shift", [(64, 1000, 0), (64, 1000, 3), (64, 5, 3), (8, 100, 4),
                                       (64, 40, 0)])
def test_cand_k_is_the_references(k, b, shift):
    assert ttopk.cand_k(k, b, shift) == jtopk.cand_k(k, b, shift)


@pytest.mark.parametrize("salt", [6, 7])
def test_talker_chunk_update_defers_like_the_reference(salt):
    """topk_every=3: salt 6 selects, salt 7 returns cand_k zeros; the talker
    CMS takes the chunk either way (the port's tail and selection, against
    the reference's talker_chunk_update)."""
    b, every, shift = 900, 3, 2
    keys, w, src, acl = _inputs(7, b, 8, src_hi=300)
    talk = _talk()
    select = ttopk.selects(salt, every)
    _, cnt, rep = port_tail(talk, torch.zeros((8, 16), dtype=torch.int64), keys, w, src, acl,
                            counts=False, salt=salt, sample_shift=shift, select=select)
    k = ttopk.cand_k(64, b, shift)
    cand = ttopk.maybe_select(
        lambda: reg_tail.select_tables(cnt, rep, _b(acl), (_b(src),), talk, k, salt=salt,
                                       sample_shift=shift),
        salt, every, k, talk.device)
    want = jtopk.talker_chunk_update(jnp.zeros((2, 1 << 10), jnp.uint32), jnp.asarray(acl),
                                     jnp.asarray(src), jnp.asarray(w), 64, salt=np.uint32(salt),
                                     sample_shift=shift, topk_every=every)
    for g, x in zip((talk, *cand), want):
        np.testing.assert_array_equal(_np(g), np.asarray(x))
    assert (int(cand[2].sum()) > 0) == (salt % every == 0)


# --- the reg_tail kernel's arithmetic -----------------------------------------


def test_tail_constants_are_the_references():
    """The constants the wrapper passes to csrc/reg_tail.cu are the
    reference's, and the source holds no hash constant of its own."""
    c = reg_tail.TAIL_CONSTANTS
    assert len(c) == 19 and all(0 <= x < 2**32 for x in c)
    assert list(c[11:]) == [int(x) for x in jhashing.MS_CONSTANTS[:8]]
    assert (c[5], c[6]) == (jhll._HLL_SEED_IDX, jhll._HLL_SEED_RANK)
    x = np.random.default_rng(8).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    y = x[::-1].copy()
    np.testing.assert_array_equal(_fmix(x, 0x1234567, c),
                                  np.asarray(jhashing.fmix32(jnp.asarray(x), seed=0x1234567)))
    np.testing.assert_array_equal(_pair(x, y, c),
                                  np.asarray(jhashing.hash_pair(jnp.asarray(x), jnp.asarray(y))))
    limbs = [np.roll(x, i) for i in range(4)]
    np.testing.assert_array_equal(
        _fold(limbs, c),
        np.asarray(jmatch6.fold_src32({f"src{i}": jnp.asarray(v) for i, v in enumerate(limbs)})))
    src = (ROOT / "ruleset_analysis_tpu_torch" / "csrc" / "reg_tail.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.findall(r"0x[0-9A-Fa-f]{5,}", code.replace("0xFFFFFFFFu", "")), \
        "reg_tail.cu holds its own constants"
    n = re.search(r"constexpr int N_CONSTS = 7 \+ FOLD_LIMBS \+ MAX_DEPTH;", code)
    assert n and "constexpr int MAX_DEPTH = 8;" in code and "constexpr int FOLD_LIMBS = 4;" in code


def _fmix(x, seed, c):
    x = (np.asarray(x, np.uint32) ^ np.uint32(seed)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(c[0])
    x ^= x >> np.uint32(13)
    x *= np.uint32(c[1])
    x ^= x >> np.uint32(16)
    return x


def _pair(a, b, c):
    return _fmix(_fmix(a, c[3], c) ^ (np.asarray(b, np.uint32) * np.uint32(c[2])), c[4], c)


def _fold(limbs, c):
    h = np.zeros(len(limbs[0]), np.uint32)
    for i, v in enumerate(limbs):
        h = (h ^ np.asarray(v, np.uint32)) * np.uint32(c[7 + i])
    return h ^ (h >> np.uint32(15))


def _clz(x):
    return np.array([32 - int(v).bit_length() for v in x], dtype=np.int64)


def _model_ids(acl, src, tag, c):
    """The kernel's line_acl / line_src: the tagged gid, the (folded) source."""
    a = (np.asarray(acl, np.uint32) | np.uint32(tag)).astype(np.uint32)
    s = np.asarray(src[0], np.uint32) if len(src) == 1 else _fold(src, c)
    return a, s


#: csrc/reg_tail.cu's warp and block, and the select's radix digit and
#: slot bits
WARP, BLOCK_THREADS, RADIX_BITS, SLOT_BITS = 32, 1024, 8, 15


def _grouped(warp, value, *vals, op=np.add):
    """Group lines by (warp, value), as __match_any_sync groups a warp's
    lanes: per group, its value and ``op`` over each of ``vals`` (u32 sums
    wrap mod 2^32)."""
    gkey = (np.asarray(warp, np.int64) << 32) | np.asarray(value, np.uint32).astype(np.int64)
    uniq, inv = np.unique(gkey, return_inverse=True)
    out = []
    for v in vals:
        acc = np.zeros(len(uniq), np.int64) if op is np.add else np.full(len(uniq), -1, np.int64)
        op.at(acc, inv, np.asarray(v, np.int64))
        out.append(acc % 2**32 if op is np.add else acc)
    return (uniq & 0xFFFFFFFF, *out)


def model_reg_tail(talk, hll, row, key_k, n_rows, w, acl, src, *, tag=0, counts, salt, shift,
                   select, slots, grid=3):
    """numpy model of csrc/reg_tail.cu's reg_tail_kernel, with TAIL_CONSTANTS
    only and the kernel's grouping: a warp takes 32 consecutive lines;
    its live lines with one pair add their u32 weight sum once to each
    talker-CMS row, and their sampled ones that sum to cnt[slot] and the
    highest lane's sample index to rep[slot]; its keyed lines with one HLL
    cell take the group's largest rank; its keyed lines with one key add
    their sum to the block's histogram (line i is block (i // 1024) % grid
    of a ``grid``-block persistent launch), flushed block by block into
    the delta.  ``row``/``key_k`` int64, ``acl``/``w`` u32, ``src`` a list
    of 1 or 4 u32 columns."""
    c = reg_tail.TAIL_CONSTANTS
    talk, hll = talk.astype(np.int64), hll.astype(np.int64)
    depth, width = talk.shape
    n_keys, m = hll.shape
    wb, p = width.bit_length() - 1, m.bit_length() - 1
    acl_raw = np.asarray(acl, np.uint32).astype(np.int64)
    n_acls = len(key_k) - n_rows
    kk = np.asarray(key_k, np.int64) % 2**32
    deny = kk[n_rows + np.minimum(acl_raw, n_acls - 1)]
    keys = np.where(row < 0, deny, np.where(row < n_rows, kk[np.clip(row, 0, n_rows - 1)],
                                            0xFFFFFFFF))
    wv = np.asarray(w, np.uint32).astype(np.int64)
    b = len(keys)
    i = np.arange(b)
    warp = i // WARP
    a, s = _model_ids(acl, src, tag, c)
    pair = _pair(a, s, c)
    live = wv != 0
    # talker CMS: one add of each pair group's sum per row
    g_pair, g_sum = _grouped(warp[live], pair[live], wv[live])
    mixed = _fmix(g_pair.astype(np.uint32), 0, c)
    for d in range(depth):
        bucket = ((mixed * np.uint32(c[11 + d])) >> np.uint32(32 - wb)).astype(np.int64)
        np.add.at(talk[d], bucket, g_sum)
    talk %= 2**32
    # HLL: each cell group's largest rank
    keyed = live & (keys < n_keys)
    reg = (_fmix(s, c[5], c) >> np.uint32(32 - p)).astype(np.int64)
    rank = _clz(_fmix(s, c[6], c)) + 1
    cell = keys * m + reg
    g_cell, g_rank = _grouped(warp[keyed], cell[keyed], rank[keyed], op=np.maximum)
    np.maximum.at(hll.reshape(-1), g_cell, g_rank)
    delta = None
    if counts:
        # each key group's sum into its block's histogram, one flush a block
        block = (i // BLOCK_THREADS) % grid
        delta = np.zeros(n_keys, np.int64)
        for blk in range(grid):
            mine = keyed & (block == blk)
            g_key, g_ksum = _grouped(warp[mine], keys[mine], wv[mine])
            hist = np.zeros(n_keys, np.int64)
            np.add.at(hist, g_key, g_ksum)
            delta += hist % 2**32
        delta %= 2**32
    cnt = rep = None
    if select:
        ok = live.copy()
        if shift and b >= (1 << shift):
            bs = (b >> shift) << shift
            ok &= (i < bs) & ((i & ((1 << shift) - 1)) == (salt & ((1 << shift) - 1)))
            sh = shift
        else:
            sh = 0
        g_pair, g_sum = _grouped(warp[ok], pair[ok], wv[ok])
        _, g_last = _grouped(warp[ok], pair[ok], i[ok], op=np.maximum)
        slot = (_fmix(g_pair.astype(np.uint32) ^ np.uint32(salt), 0, c)
                & np.uint32(slots - 1)).astype(np.int64)
        cnt = np.zeros(slots, np.int64)
        np.add.at(cnt, slot, g_sum)
        cnt %= 2**32
        rep = np.full(slots, -1, np.int64)
        np.maximum.at(rep, slot, g_last >> sh)  # the highest lane's sample index
    return talk, hll, delta, cnt, rep


def model_select(cnt, rep, acl, src, talk, k, *, tag=0, salt, shift):
    """numpy model of csrc/reg_tail.cu's select_kernel, fed only the table
    and TAIL_CONSTANTS: a radix select (8-bit digits from the largest
    positive count's top digit) of the k-th positive int32 count C and how
    many ties at C win; the compaction of the slots above C and of the
    lowest-slot ties; each winner ranked by counting the larger keys
    (count, then the lower slot); the pick; zero past the winners."""
    c = reg_tail.TAIL_CONSTANTS
    slots = len(cnt)
    c32 = np.asarray(cnt, np.int64).astype(np.uint32).view(np.int32).astype(np.int64)
    pos = c32 > 0
    thresh, ties = 0, 0
    if pos.sum() > k:
        prefix, mask, left = 0, 0, k
        for sh in range((int(c32[pos].max()).bit_length() - 1) // RADIX_BITS * RADIX_BITS, -1,
                        -RADIX_BITS):
            inn = pos & ((c32 & mask) == prefix)
            hist = np.bincount((c32[inn] >> sh) & 255, minlength=1 << RADIX_BITS)
            at_or_above = np.cumsum(hist[::-1])[::-1]
            d = int(np.flatnonzero(at_or_above >= left).max())
            left -= int(at_or_above[d] - hist[d])
            prefix |= d << sh
            mask |= 255 << sh
        thresh, ties = prefix, left
    win = np.concatenate([np.flatnonzero(c32 > thresh),
                          np.flatnonzero((c32 == thresh) & (thresh > 0))[:ties]])
    assert len(win) == min(k, int(pos.sum()))
    keys = (c32[win] << SLOT_BITS) | (slots - 1 - win)
    at = (keys[None, :] > keys[:, None]).sum(axis=1)
    a_all, s_all = _model_ids(acl, src, tag, c)
    b = len(a_all)
    sh, phase = (shift, salt % (1 << shift)) if shift and b >= (1 << shift) else (0, 0)
    depth, width = talk.shape
    wb = width.bit_length() - 1
    out = np.zeros((3, k), np.int64)
    r = np.asarray(rep, np.int64)[win]
    line = (np.maximum(r, 0) << sh) + phase
    a, x = a_all[line], s_all[line]
    mixed = _fmix(_pair(a, x, c), 0, c)
    est = np.min([talk[d, ((mixed * np.uint32(c[11 + d])) >> np.uint32(32 - wb)).astype(np.int64)]
                  for d in range(depth)], axis=0) if len(win) else np.zeros(0, np.int64)
    ok = r >= 0
    out[:, at] = np.stack([np.where(ok, a, 0), np.where(ok, x, 0), np.where(ok, est, 0)])
    return out


def _tail_case(b, n_keys, *, seed, w_hi, v6):
    """Match rows (no-match and past-the-table ones among them), a key table
    over 40 rows and 6 ACLs with out-of-range keys, weights, acls (some past
    the last ACL) and sources (four limbs for v6)."""
    rng = np.random.default_rng(seed)
    n_rows, n_acls = 40, 6
    row = rng.integers(-1, n_rows + 2, b)
    key_k = rng.integers(0, n_keys + 5, n_rows + n_acls)
    w = rng.integers(0, w_hi, b, dtype=np.uint64).astype(np.uint32)
    acl = rng.integers(0, n_acls + 2, b).astype(np.uint32)
    src = [rng.integers(0, 400, b).astype(np.uint32) for _ in range(4 if v6 else 1)]
    return row, key_k, n_rows, w, acl, src


def _check_tail(b, shift, salt, counts, select, big, v6):
    n_keys, slots = 23, 1 << 10
    tag = pipeline.V6_ACL_TAG if v6 else 0
    row, key_k, n_rows, w, acl, src = _tail_case(b, n_keys, seed=9 + b, w_hi=2**32 if big else 4,
                                                 v6=v6)
    rng = np.random.default_rng(b)
    talk0 = rng.integers(0, 2**32, (2, 1 << 9), dtype=np.uint64).astype(np.int64)
    hll0 = rng.integers(0, 4, (n_keys, 1 << 6)).astype(np.int64)
    talk, hll = torch.from_numpy(talk0.copy()), torch.from_numpy(hll0.copy())
    t_src = tuple(_b(x) for x in src)
    delta, cnt, rep = reg_tail.reg_tail(talk, hll, _b(row), _b(w), _b(acl), t_src, _b(key_k),
                                        n_rows=n_rows, acl_tag=tag, counts=counts, salt=salt,
                                        sample_shift=shift, select=select, slots=slots)
    m_talk, m_hll, m_delta, m_cnt, m_rep = model_reg_tail(
        talk0, hll0, row, key_k, n_rows, w, acl, src, tag=tag, counts=counts, salt=salt,
        shift=shift, select=select, slots=slots)
    np.testing.assert_array_equal(talk.numpy(), m_talk)
    np.testing.assert_array_equal(hll.numpy(), m_hll)
    if counts:
        np.testing.assert_array_equal(delta.numpy(), m_delta)
    else:
        assert delta is None
    if not select:
        assert cnt is None and rep is None
        return
    np.testing.assert_array_equal(cnt.numpy(), m_cnt)
    np.testing.assert_array_equal(rep.numpy(), m_rep)
    k = ttopk.cand_k(min(16, b), b, shift)
    got = reg_tail.select_tables(cnt, rep, _b(acl), t_src, talk, k, acl_tag=tag, salt=salt,
                                 sample_shift=shift)
    want = model_select(m_cnt, m_rep, acl, src, m_talk, k, tag=tag, salt=salt, shift=shift)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    a, s = _model_ids(acl, src, tag, reg_tail.TAIL_CONSTANTS)
    s_acl, s_src, _ = jtopk.sample_cols(jnp.asarray(a), jnp.asarray(s), jnp.asarray(w),
                                        np.uint32(salt), shift)
    jgot = jtopk.select_from_tables(jnp.asarray(m_cnt.astype(np.uint32)),
                                    jnp.asarray(m_rep.astype(np.int32)), s_acl, s_src,
                                    jnp.asarray(m_talk.astype(np.uint32)), k)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.stack([np.asarray(x) for x in jgot]).astype(np.int64))


TAIL_CASES = [
    # (b, shift, salt, counts, select, big weights)
    (2003, 0, 3, True, True, False),
    (2003, 3, 11, True, True, False),
    (2003, 3, 11, False, True, True),
    (1, 3, 5, True, True, False),
    (2003, 0, 4, True, False, False),
    (700, 2, 0xFFFFFFFF, False, True, True),
]


@pytest.mark.parametrize("b,shift,salt,counts,select,big", TAIL_CASES)
def test_reg_tail_plain_equals_the_kernel_model(b, shift, salt, counts, select, big):
    """The wrapper on CPU tensors (the plain version) equals the model of
    the CUDA kernel's arithmetic, and its pick equals the pick kernel's
    model and the reference's select_from_tables."""
    _check_tail(b, shift, salt, counts, select, big, v6=False)


@pytest.mark.parametrize("b,shift,salt,counts,select,big", TAIL_CASES[:3])
def test_reg_tail_plain_equals_the_kernel_model_v6(b, shift, salt, counts, select, big):
    """The same over v6 lines: four source limbs folded, the gid tagged."""
    _check_tail(b, shift, salt, counts, select, big, v6=True)


REG_TAIL_CASES = list(synth.reg_tail_cases(1, 2))


@pytest.mark.parametrize("name", REG_TAIL_CASES)
def test_grouped_model_equals_plain_over_reg_tail_cases(name):
    """The kernel's grouped arithmetic (warp groups, block histograms, the
    radix select) gives the plain version's registers, delta, table and
    candidates bit for bit on every synth.reg_tail_cases entry."""
    n_keys, width, p = 300, 1 << 12, 8
    case = synth.reg_tail_cases(4099, n_keys, seed=3)[name]
    rng = np.random.default_rng(9)
    talk0 = rng.integers(0, 1 << 32, (2, width), dtype=np.uint64).astype(np.int64)
    hll0 = rng.integers(0, 5, (n_keys, 1 << p)).astype(np.int64)
    talk, hll = torch.from_numpy(talk0.copy()), torch.from_numpy(hll0.copy())
    kw = {k: case[k] for k in ("counts", "select", "sample_shift", "salt", "acl_tag", "n_rows")}
    t_src = tuple(torch.from_numpy(x) for x in case["src"])
    row, valid, acl, key_k = (torch.from_numpy(case[k]) for k in ("row", "valid", "acl", "key_k"))
    delta, cnt, rep = reg_tail.reg_tail_plain(talk, hll, row, valid, acl, t_src, key_k, **kw)
    u32 = [np.asarray(x).view(np.uint32) for x in case["src"]]
    m_talk, m_hll, m_delta, m_cnt, m_rep = model_reg_tail(
        talk0, hll0, case["row"].astype(np.int64), case["key_k"].astype(np.int64),
        case["n_rows"], case["valid"].view(np.uint32), case["acl"].view(np.uint32), u32,
        tag=case["acl_tag"], counts=kw["counts"], salt=kw["salt"], shift=kw["sample_shift"],
        select=kw["select"], slots=ttopk.CAND_SLOTS)
    np.testing.assert_array_equal(talk.numpy(), m_talk)
    np.testing.assert_array_equal(hll.numpy(), m_hll)
    assert (delta is None) == (m_delta is None) and (cnt is None) == (m_cnt is None)
    if delta is not None:
        np.testing.assert_array_equal(delta.numpy(), m_delta)
    if cnt is None:
        return
    np.testing.assert_array_equal(cnt.numpy(), m_cnt)
    np.testing.assert_array_equal(rep.numpy(), m_rep)
    b = row.shape[0]
    k = ttopk.cand_k(64, b, kw["sample_shift"])
    got = reg_tail.select_tables_plain(cnt, rep, acl, t_src, talk, k, acl_tag=kw["acl_tag"],
                                       salt=kw["salt"], sample_shift=kw["sample_shift"])
    want = model_select(m_cnt, m_rep, case["acl"].view(np.uint32), u32, m_talk, k,
                        tag=kw["acl_tag"], salt=kw["salt"], shift=kw["sample_shift"])
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


def test_grouped_model_block_flush_is_grid_independent():
    """The counts delta of the model's block histograms does not depend on
    how many blocks the persistent grid has (one, three, or the 264 of the
    H100)."""
    case = synth.reg_tail_cases(5000, 40, seed=8)["scan route (delta in the kernel), selecting"]
    args = (np.zeros((2, 1 << 10), np.int64), np.zeros((40, 16), np.int64),
            case["row"].astype(np.int64), case["key_k"].astype(np.int64), case["n_rows"],
            case["valid"].view(np.uint32), case["acl"].view(np.uint32),
            [case["src"][0].view(np.uint32)])
    kw = dict(counts=True, salt=7, shift=0, select=False, slots=1 << 10)
    deltas = [model_reg_tail(*args, grid=g, **kw)[2] for g in (1, 3, 264)]
    assert int(deltas[0].sum()) > 0
    for d in deltas[1:]:
        np.testing.assert_array_equal(d, deltas[0])


SELECT_SLOTS, SELECT_LINES = 1 << 10, 3000


@pytest.mark.parametrize("k", [1, 63, 64, SELECT_SLOTS], ids=["k=1", "k=63", "k=64", "k=slots"])
@pytest.mark.parametrize("name", list(synth.select_cases(2, 2)))
def test_select_model_equals_plain_and_reference(name, k):
    """The select kernel's radix select, compaction and ranking (numpy model)
    equal select_tables_plain and the reference's select_from_tables over
    every synth.select_cases table: all zero, all equal, counts of 2^31 and
    more, ties, empty reps; k from 1 to the whole table."""
    case = synth.select_cases(SELECT_SLOTS, SELECT_LINES, seed=11)[name]
    rng = np.random.default_rng(5)
    acl = rng.integers(0, 9, SELECT_LINES).astype(np.uint32)
    src = rng.integers(0, 2**32, SELECT_LINES, dtype=np.uint64).astype(np.uint32)
    talk = rng.integers(0, 1 << 20, (2, 1 << 9)).astype(np.int64)
    got = reg_tail.select_tables(torch.from_numpy(case["cnt"]), torch.from_numpy(case["rep"]),
                                 _b(acl), (_b(src),), torch.from_numpy(talk), k)
    got = torch.stack(got).numpy()
    want = model_select(case["cnt"], case["rep"], acl, [src], talk, k, salt=0, shift=0)
    np.testing.assert_array_equal(got, want)
    jgot = jtopk.select_from_tables(jnp.asarray(case["cnt"].astype(np.uint32)),
                                    jnp.asarray(case["rep"].astype(np.int32)), jnp.asarray(acl),
                                    jnp.asarray(src), jnp.asarray(talk.astype(np.uint32)), k)
    np.testing.assert_array_equal(got, np.stack([np.asarray(x) for x in jgot]).astype(np.int64))


def test_select_refuses_k_past_the_table():
    t = torch.zeros(8, dtype=torch.int32)
    cnt, rep = torch.zeros(16, dtype=torch.int64), torch.full((16,), -1, dtype=torch.int64)
    with pytest.raises(ValueError, match="k must be in 0..16"):
        reg_tail.select_tables(cnt, rep, t, (t,), torch.zeros((2, 16), dtype=torch.int64), 17)


def test_key_table_and_line_keys_are_rows_to_keys():
    """key_table + line_keys (the kernel's row -> key) equal the reference's
    rows_to_keys on a shipped ruleset, no-match rows and stray acl ids too."""
    from ruleset_analysis_tpu.ops.match import rows_to_keys

    cfg_text = rsynth.synth_config(n_acls=3, rules_per_acl=18, seed=31)
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(cfg_text, "fw1")])
    rules = pipeline.ship_ruleset(rpacked, "cpu")
    n_real = rpacked.rules.shape[0]
    rng = np.random.default_rng(12)
    row = rng.integers(-1, n_real, 3000)
    acl = rng.integers(0, 6, 3000).astype(np.uint32)
    got = reg_tail.line_keys(_b(row), _b(acl), rules.key_k, rules.rules_k.shape[0])
    want = rows_to_keys(jnp.asarray(row.astype(np.int64).astype(np.uint32)),
                        jnp.asarray(rpacked.rules), jnp.asarray(rpacked.deny_key),
                        jnp.asarray(acl))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_reg_tail_refuses_bad_inputs():
    t = torch.zeros(8, dtype=torch.int32)
    key_k = torch.zeros(5, dtype=torch.int32)
    talk, hll = torch.zeros((2, 16), dtype=torch.int64), torch.zeros((3, 4), dtype=torch.int64)
    kw = dict(n_rows=4, counts=True)
    with pytest.raises(ValueError, match="int32"):
        reg_tail.reg_tail(talk, hll, t.to(torch.int64), t, t, (t,), key_k, **kw)
    with pytest.raises(ValueError, match=r"\[8\]"):
        reg_tail.reg_tail(talk, hll, t, t[:4], t, (t,), key_k, **kw)
    with pytest.raises(ValueError, match="power of two"):
        reg_tail.reg_tail(torch.zeros((2, 12), dtype=torch.int64), hll, t, t, t, (t,), key_k, **kw)
    with pytest.raises(ValueError, match="1 or 4 columns"):
        reg_tail.reg_tail(talk, hll, t, t, t, (t, t), key_k, **kw)
    with pytest.raises(ValueError, match="n_acls >= 1"):
        reg_tail.reg_tail(talk, hll, t, t, t, (t,), key_k, n_rows=5, counts=True)


# --- the step, chunk by chunk -------------------------------------------------

B = 512
N_CHUNKS = 4
SKETCH = dict(cms_width=1 << 10, cms_depth=2, hll_p=6)

#: (update_impl, counts_impl, topk_every, topk_sample_shift)
STEP_PATHS = [
    ("sorted", "scatter", 1, 0),
    ("scatter", "matmul", 1, 0),
    ("scatter", "reduce", 1, 0),
    ("sorted", "reduce", 3, 2),
    ("scatter", "scatter", 3, 3),
    ("sorted", "matmul", 2, 0),
]


@pytest.fixture(scope="module")
def step_case():
    """Four weighted tuple-layout batches (weights 0..5 on the valid plane,
    as a coalesced batch carries them), some with corrupt acl ids."""
    cfg_text = rsynth.synth_config(n_acls=3, rules_per_acl=18, seed=31)
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(cfg_text, "fw1")])
    rng = np.random.default_rng(41)
    batches = []
    for c in range(N_CHUNKS):
        t = rsynth.synth_tuples(rpacked, B, seed=200 + c)
        t[:, 6] = rng.integers(0, 6, B)
        t[rng.random(B) < 0.02, 0] = 5
        batches.append(np.ascontiguousarray(t.T))
    return rpacked, batches


@pytest.mark.parametrize("update_impl,counts_impl,every,shift", STEP_PATHS)
def test_step_paths_equal_the_reference_chunk_by_chunk(step_case, update_impl, counts_impl,
                                                       every, shift):
    rpacked, batches = step_case
    kw = dict(topk_every=every, topk_sample_shift=shift)
    jcfg = JConfig(batch_size=B, sketch=JSketch(**SKETCH))
    step = jax.jit(functools.partial(jpipe.analysis_step, n_keys=rpacked.n_keys,
                                     topk_k=jcfg.sketch.topk_chunk_candidates,
                                     counts_impl=counts_impl, update_impl=update_impl, **kw))
    jrules = jpipe.ship_ruleset(rpacked)
    jstate = jpipe.init_state(rpacked.n_keys, jcfg)
    cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), match_impl="scan",
                         counts_impl=counts_impl, update_impl=update_impl, device="cpu")
    rules = pipeline.ship_ruleset(rpacked, "cpu")
    state = pipeline.init_state(rpacked.n_keys, cfg, "cpu")
    for c, batch in enumerate(batches):
        jstate, jout = step(jstate, jrules, batch, salt=np.uint32(c))
        state, out = pipeline.analysis_step(
            state, rules, torch.from_numpy(batch.view(np.int32)), n_keys=rpacked.n_keys,
            topk_k=cfg.sketch.topk_chunk_candidates, salt=c, match_impl="scan", **kw)
        want = jpipe.state_to_host(jstate)
        got = pipeline.state_to_numpy(state)
        for k in pipeline.AnalysisState._fields:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"chunk {c} {k}")
        for name, g, x in zip(pipeline.ChunkOut._fields, out, jout):
            np.testing.assert_array_equal(_np(g), np.asarray(x), err_msg=f"chunk {c} {name}")
        if every > 1 and c % every:
            assert int(out.cand_est.sum()) == 0
