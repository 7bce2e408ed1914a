"""The port's pair relations (ops/overlap.py) against the reference's.

The reference's ``tests/test_overlap.py`` cases, each run through both
packages on the same rule rows (made with numpy from a seed): the port's
``relation_tile`` takes them as int32 u32 bits on the CPU (its plain
version; the CUDA kernel is held to it in ``test_torch_cuda.py``), the
reference's as uint32.  Then random tiles with NO_ACL padding, cross-ACL
rows and u32 extremes, and the tile grid at 4, 16 and 512, with and
without ``lower_only``, with ``on_tile`` called in the same order.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu.ops import overlap as roverlap  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import synth  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import NO_ACL, R_ACL, RULE_COLS  # noqa: E402
from ruleset_analysis_tpu_torch.ops import overlap  # noqa: E402

_FIELD_LOHI = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10)]
U32_MAX = 0xFFFFFFFF


def random_rules(rng, r, n_acls=2, pad=0):
    """The reference test's rows: lo <= hi everywhere, some 'any' fields."""
    rules = np.zeros((r + pad, RULE_COLS), dtype=np.uint32)
    rules[:, R_ACL] = NO_ACL
    for i in range(r):
        rules[i, R_ACL] = rng.integers(0, n_acls)
        rules[i, 11] = i
        for lo, hi in _FIELD_LOHI:
            if rng.random() < 0.25:
                a, b = 0, U32_MAX
            else:
                a, b = sorted(rng.integers(0, 100, size=2))
            rules[i, lo], rules[i, hi] = a, b
    return rules


def bits(rows: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint32).view(np.int32))


def tile_both(rows_i, rows_j):
    cov, ovl = overlap.relation_tile(bits(rows_i), bits(rows_j))
    rcov, rovl = roverlap.relation_tile(rows_i, rows_j)
    return (cov.numpy(), ovl.numpy()), (np.asarray(rcov), np.asarray(rovl))


def relations_both(rules, **kw):
    calls, rcalls = [], []
    got = overlap.pair_relations(rules, on_tile=lambda i0, j0: calls.append((i0, j0)), **kw)
    want = roverlap.pair_relations(rules, on_tile=lambda i0, j0: rcalls.append((i0, j0)), **kw)
    assert calls == rcalls
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got, calls


def test_constants_equal_the_references():
    assert overlap.PAIR_TILE == roverlap.PAIR_TILE == 512
    assert overlap._FIELDS == roverlap._FIELDS


def test_relation_tile_matches_numpy_twin():
    rng = np.random.default_rng(0)
    rules = random_rules(rng, 40, n_acls=3, pad=8)
    (cov, ovl), (rcov, rovl) = tile_both(rules, rules)
    np.testing.assert_array_equal(cov, rcov)
    np.testing.assert_array_equal(ovl, rovl)
    cov_np, ovl_np = overlap.pair_relations_np(rules)
    np.testing.assert_array_equal(cov, cov_np)
    np.testing.assert_array_equal(ovl, ovl_np)
    assert cov.dtype == np.bool_ and cov.shape == (48, 48)
    assert not (cov_np & ~ovl_np).any()
    assert not cov_np[40:].any() and not cov_np[:, 40:].any()
    assert not ovl_np[40:].any() and not ovl_np[:, 40:].any()


def test_cross_acl_rows_never_relate():
    rng = np.random.default_rng(1)
    rules = random_rules(rng, 20, n_acls=1)
    other = rules.copy()
    other[:, R_ACL] = 1
    both = np.concatenate([rules, other])
    (_, ovl), _ = relations_both(both)
    assert not ovl[:20, 20:].any() and not ovl[20:, :20].any()
    assert ovl[np.arange(20), np.arange(20)].all()


def test_known_relations():
    def row(acl, plo, phi, slo, shi):
        return [acl, plo, phi, slo, shi, 0, 65535, 0, 0xFFFFFFFF, 0, 65535, 0]

    rules = np.asarray([row(0, 6, 6, 10, 20), row(0, 6, 6, 0, 100), row(0, 6, 6, 15, 30),
                        row(0, 17, 17, 10, 20)], dtype=np.uint32)
    (cov, ovl), _ = relations_both(rules)
    assert cov[0, 1] and not cov[1, 0]
    assert ovl[0, 2] and not cov[0, 2] and not cov[2, 0]
    assert not ovl[0, 3] and not ovl[3, 0]
    assert cov[0, 0]


@pytest.mark.parametrize("tile", [4, 16])
def test_tiled_grid_equals_single_tile(tile):
    rng = np.random.default_rng(2)
    rules = random_rules(rng, 37, n_acls=2)
    one, _ = relations_both(rules)
    tiled, _ = relations_both(rules, tile=tile)
    np.testing.assert_array_equal(one[0], tiled[0])
    np.testing.assert_array_equal(one[1], tiled[1])


def test_tile_grid_iterator_covers_every_pair_once():
    for r, t in ((37, 16), (1, 4), (512, 512), (513, 512)):
        assert list(overlap.iter_pair_tiles(r, t)) == list(roverlap.iter_pair_tiles(r, t))
        seen = np.zeros((r, r), dtype=int)
        for i0, i1, j0, j1 in overlap.iter_pair_tiles(r, t):
            seen[i0:i1, j0:j1] += 1
        assert (seen == 1).all()


def test_on_tile_seam_fires_per_tile_and_devices_shard():
    rng = np.random.default_rng(3)
    rules = random_rules(rng, 33, n_acls=2)
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    calls = []
    cov, ovl = overlap.pair_relations(rules, tile=16, devices=devs,
                                      on_tile=lambda i0, j0: calls.append((i0, j0)))
    assert len(calls) == 9
    (c2, o2), _ = relations_both(rules, tile=overlap.PAIR_TILE)
    np.testing.assert_array_equal(cov, c2)
    np.testing.assert_array_equal(ovl, o2)


def test_lower_only_skips_upper_triangle_tiles_losslessly():
    rng = np.random.default_rng(4)
    rules = random_rules(rng, 33, n_acls=2)
    (cov, ovl), calls = relations_both(rules, tile=16, lower_only=True)
    assert all(j0 <= i0 for i0, j0 in calls)
    assert len(calls) == 6
    (full_cov, full_ovl), _ = relations_both(rules, tile=16)
    lower = (np.arange(33)[None, :] // 16) <= (np.arange(33)[:, None] // 16)
    np.testing.assert_array_equal(cov, full_cov & lower)
    np.testing.assert_array_equal(ovl, full_ovl & lower)


def test_empty_and_single_row():
    empty = np.zeros((0, RULE_COLS), dtype=np.uint32)
    cov, ovl = overlap.pair_relations(empty)
    assert cov.shape == (0, 0) and ovl.shape == (0, 0)
    one = np.zeros((1, RULE_COLS), dtype=np.uint32)
    one[0, 2] = 255
    (cov, ovl), calls = relations_both(one)
    assert cov[0, 0] and ovl[0, 0] and calls == [(0, 0)]


@pytest.mark.parametrize("seed", range(6))
def test_random_edge_tiles_equal_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ti, tj = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    rows_i = synth.relation_edge_rows(ti, seed=100 + seed)
    rows_j = np.concatenate([synth.relation_edge_rows(tj, seed=200 + seed), rows_i[: tj // 3]])
    (cov, ovl), (rcov, rovl) = tile_both(rows_i, rows_j)
    np.testing.assert_array_equal(cov, rcov)
    np.testing.assert_array_equal(ovl, rovl)
    # a padding row relates to nothing, a real row overlaps (and covers) itself
    pad_i = rows_i[:, R_ACL] == NO_ACL
    assert not cov[pad_i].any() and not ovl[pad_i].any()
    both = np.concatenate([rows_i, rows_j])
    c, o = overlap.pair_relations_np(both)
    real = both[:, R_ACL] != NO_ACL
    assert c[real, real].all() and o[real, real].all()
    assert not (c & ~o).any()


@pytest.mark.parametrize("tile", [4, 16, 512])
@pytest.mark.parametrize("lower_only", [False, True])
def test_pair_relations_equal_reference_and_numpy_twin(tile, lower_only):
    rng = np.random.default_rng(7 + tile)
    rules = np.concatenate([synth.relation_edge_rows(29, seed=tile),
                            random_rules(rng, 24, n_acls=3)])
    rules = rules[rng.permutation(rules.shape[0])]
    (cov, ovl), calls = relations_both(rules, tile=tile, lower_only=lower_only)
    cov_np, ovl_np = overlap.pair_relations_np(rules)
    if lower_only:
        lower = (np.arange(53)[None, :] // tile) <= (np.arange(53)[:, None] // tile)
        cov_np, ovl_np = cov_np & lower, ovl_np & lower
    np.testing.assert_array_equal(cov, cov_np)
    np.testing.assert_array_equal(ovl, ovl_np)
    n = -(-53 // tile)
    assert len(calls) == (n * (n + 1) // 2 if lower_only else n * n)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rows = bits(random_rules(np.random.default_rng(5), 4))
    with pytest.raises(ValueError, match="int32"):
        overlap.relation_tile(rows.to(torch.int64), rows)
    with pytest.raises(ValueError, match=r"\[T, 12\]"):
        overlap.relation_tile(rows[:, :11].contiguous(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        overlap.relation_tile(rows.t().contiguous().t(), rows)
    cov, ovl = overlap.relation_tile(rows[:0], rows)
    assert cov.shape == (0, 4) and ovl.shape == (0, 4)


@pytest.fixture(scope="module")
def rules2048():
    """The rows of one ACL of 2048 rules (3335 rows): the largest flat point
    of the reference's rule-scale sweep."""
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack

    text = synth.synth_config(n_acls=1, rules_per_acl=2048, seed=2048)
    return pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")]).rules


def test_edge_tiles_equal_the_reference(rules2048):
    assert rules2048.shape[0] == 3335
    for name, (rows_i, rows_j) in synth.relation_edge_cases(rules2048).items():
        (cov, ovl), (rcov, rovl) = tile_both(rows_i, rows_j)
        np.testing.assert_array_equal(cov, rcov, err_msg=name)
        np.testing.assert_array_equal(ovl, rovl, err_msg=name)
        assert cov.shape == (rows_i.shape[0], rows_j.shape[0])


def test_the_2048_rule_acl_runs_28_lower_tiles_as_in_the_reference(rules2048):
    (cov, ovl), calls = relations_both(rules2048, lower_only=True)
    assert len(calls) == 28
    assert cov[np.arange(3335), np.arange(3335)].all()


# ---------------------------------------------------------------------------
# relation_grid: every tile of a work list, as bit-packed words.
# ---------------------------------------------------------------------------


def model_relation_grid(blocks, work, tile):
    """numpy model of csrc/relation_tile.cu's relation_grid_kernel, fed only
    the kernel's constants (its block shape, 32 bits a word, the row layout):
    the grid's block -> (tile, i-strip, j-span) split, the j-span staged
    with NO_ACL rows past the tile, one thread an i-row, one word of each
    matrix per 32 j-rows at ``(t * words + w) * tile + a``.  Every output
    word starts as poison, so a word the grid does not write shows."""
    rows, span_words = overlap.GRID_ROWS, overlap.GRID_WORDS
    bits = overlap.WORD_BITS
    words = -(-tile // bits)
    spans = -(-words // span_words)
    per_tile = -(-tile // rows) * spans
    n_t = work.shape[0]
    out = np.full((2, n_t * words * tile), 0xDEADBEEF, dtype=np.uint32)
    lo_cols = [lo for lo, _ in overlap._FIELDS]
    hi_cols = [hi for _, hi in overlap._FIELDS]
    weight = np.uint64(1) << np.arange(bits, dtype=np.uint64)
    for block in range(n_t * per_tile):
        t = block // per_tile
        strip, span = divmod(block - t * per_tile, spans)
        bi, bj = (int(x) for x in work[t])
        j0 = span * span_words * bits
        sj = np.zeros((span_words * bits, RULE_COLS), dtype=np.uint32)
        sj[:, R_ACL] = NO_ACL
        n_j = max(0, min(span_words * bits, tile - j0))
        sj[:n_j] = blocks[bj * tile + j0: bj * tile + j0 + n_j]
        a = strip * rows + np.arange(rows)
        a = a[a < tile]
        ri = blocks[bi * tile + a].astype(np.uint64)
        w0 = span * span_words
        for u in range(min(span_words, words - w0)):
            b = sj[u * bits:(u + 1) * bits].astype(np.uint64)
            cov = b[None, :, R_ACL] == ri[:, None, R_ACL]
            ovl = cov.copy()
            for lo, hi in zip(lo_cols, hi_cols):
                la, ha = ri[:, None, lo], ri[:, None, hi]
                lb, hb = b[None, :, lo], b[None, :, hi]
                cov &= (lb <= la) & (ha <= hb)
                ovl &= np.maximum(la, lb) <= np.minimum(ha, hb)
            pad = ri[:, R_ACL] == NO_ACL
            o = (t * words + w0 + u) * tile + a
            for m, rel in enumerate((cov, ovl)):
                word = (rel.astype(np.uint64) * weight).sum(axis=1)
                out[m, o] = np.where(pad, 0, word).astype(np.uint32)
    return out.reshape(2, n_t, words, tile)


def unpack_words_np(words: np.ndarray, n: int) -> np.ndarray:
    """numpy twin of ``overlap.unpack_words``: int32 or uint32 words ``[...,
    W, T]`` -> bool ``[..., T, n]``, with ``np.unpackbits(...,
    bitorder="little")`` on the little-endian bytes of the words transposed
    to ``[..., T, W]``."""
    le = np.ascontiguousarray(np.swapaxes(words, -1, -2)).view(np.uint32)
    le = le.astype("<u4", copy=False).view(np.uint8)
    return np.unpackbits(le, axis=-1, bitorder="little").view(bool)[..., :n]


def schedule(rules, tile, n_devices=1, lower_only=False):
    """(tiles, [(blocks int32 tensor, work tensor)] a device) of one slab."""
    tiles, per_device = overlap.grid_work([rules.shape[0]], tile, n_devices, lower_only)
    inputs = []
    for index, work in per_device:
        blocks = [overlap._pad_rows(rules[b0:b0 + tile], tile) for _s, b0 in index]
        blocks = np.concatenate(blocks) if blocks else np.zeros((0, RULE_COLS), np.uint32)
        inputs.append((bits(blocks), torch.from_numpy(work)))
    return tiles, inputs


def mixed_rules(seed, r, n_acls=3):
    """Random multi-ACL rows and u32 edge rows, shuffled, with padding rows."""
    rng = np.random.default_rng(seed)
    rules = np.concatenate([random_rules(rng, r - r // 3, n_acls=n_acls),
                            synth.relation_edge_rows(r // 3, n_acls=n_acls, seed=seed)])
    return rules[rng.permutation(r)]


def test_grid_constants_are_the_kernels():
    """The block shape the wrapper and the model use is the one the .cu
    compiles (its ROWS and WORDS), and the grid's size follows from it."""
    import pathlib
    import re

    src = (pathlib.Path(overlap.__file__).parent.parent / "csrc" / "relation_tile.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (int(consts["ROWS"]), int(consts["WORDS"])) == (overlap.GRID_ROWS,
                                                          overlap.GRID_WORDS) == (128, 2)
    assert "template" not in src
    assert overlap.WORD_BITS == 32
    assert overlap.words_of(512) == 16 and overlap.words_of(1) == 1
    assert overlap.words_of(33) == 2
    # 28 tiles of 512: 4 i-strips x 8 j-spans a tile
    assert overlap.grid_size(28, 512) == 28 * 32
    assert overlap.grid_size(3, 33) == 3 * 1 * 1


@pytest.mark.parametrize("tile", [16, 64, 512])
@pytest.mark.parametrize("lower_only", [False, True])
@pytest.mark.parametrize("n_devices", [1, 2])
@pytest.mark.parametrize("r", [1, 37, 150])
def test_relation_grid_plain_equals_reference_tile_by_tile(tile, lower_only, n_devices, r):
    """Random multi-ACL rows with a ragged last block: each tile's words,
    unpacked on the host, are the reference's pair_relations in that tile."""
    rules = mixed_rules(tile + r, r)
    want = roverlap.pair_relations(rules, tile=tile, lower_only=lower_only)
    tiles, inputs = schedule(rules, tile, n_devices, lower_only)
    words = [torch.stack(overlap.relation_grid_plain(b, w, tile)).numpy() for b, w in inputs]
    for _s, i0, i1, j0, j1, d, k in tiles:
        got = unpack_words_np(words[d][:, k], j1 - j0)
        assert got.shape == (2, tile, j1 - j0)
        for m in (0, 1):
            np.testing.assert_array_equal(got[m, : i1 - i0], np.asarray(want[m])[i0:i1, j0:j1])
        # rows past the slab are padding: they relate to nothing
        assert not got[:, i1 - i0:].any()
    n = -(-r // tile)
    assert len(tiles) == (n * (n + 1) // 2 if lower_only else n * n)
    assert sum(w.shape[0] for _, w in inputs) == len(tiles)


def test_relation_grid_plain_of_the_empty_ruleset():
    tiles, inputs = schedule(np.zeros((0, RULE_COLS), np.uint32), 512)
    assert tiles == [] and inputs[0][1].shape == (0, 2)
    cov, ovl = overlap.relation_grid(*inputs[0], 512)
    assert cov.shape == ovl.shape == (0, 16, 512)
    got = list(overlap.pair_relations_many([], tile=512))
    assert got == []


@pytest.mark.parametrize("tile,r,lower_only", [
    (512, 700, True), (64, 150, False), (33, 70, True), (16, 40, False), (1, 5, False),
    (600, 601, False), (512, 513, False), (128, 300, True), (64, 64, False), (65, 200, True),
    (96, 97, False), (32, 200, True), (200, 190, False), (256, 257, True), (31, 63, False),
    (2, 9, True), (40, 120, False), (300, 610, True), (127, 255, False), (160, 330, True),
    (63, 190, True), (129, 129, False), (8, 50, True), (512, 20, False),
])
def test_word_layout_model_equals_the_reference(tile, r, lower_only):
    """The numpy model of the kernel's grid and word layout writes every word
    once, equals the plain version word for word, and unpacks to the
    reference's bool matrices."""
    rules = mixed_rules(r + tile, r)
    want = roverlap.pair_relations(rules, tile=tile, lower_only=lower_only)
    tiles, [(blocks, work)] = schedule(rules, tile, lower_only=lower_only)
    model = model_relation_grid(blocks.numpy().view(np.uint32), work.numpy(), tile)
    plain = torch.stack(overlap.relation_grid_plain(blocks, work, tile)).numpy()
    np.testing.assert_array_equal(model.view(np.int32), plain)
    for _s, i0, i1, j0, j1, _d, k in tiles:
        got = unpack_words_np(model[:, k], j1 - j0)
        for m in (0, 1):
            np.testing.assert_array_equal(got[m, : i1 - i0], np.asarray(want[m])[i0:i1, j0:j1])


def test_word_bit_order_is_pinned():
    """Bit k of word (t, w, a) is row a against j-row 32 w + k: one covering
    j-row at each of a few positions lights exactly its bit."""
    tile = 70
    rows = np.zeros((2 * tile, RULE_COLS), dtype=np.uint32)
    rows[:, R_ACL] = NO_ACL
    rows[0, R_ACL] = 0  # i-row 0: the point box (0, ..., 0)
    for j in (0, 1, 31, 32, 63, 69):
        rows[tile + j, R_ACL] = 0
        rows[tile + j, 2::2] = U32_MAX  # [0, 2^32 - 1] on every field
    cov, ovl = overlap.relation_grid(bits(rows), torch.tensor([[0, 1]], dtype=torch.int32),
                                     tile)
    want = np.zeros(3, dtype=np.uint32)
    for j in (0, 1, 31, 32, 63, 69):
        want[j // 32] |= np.uint32(1 << (j % 32))
    for words in (cov, ovl):
        got = words.numpy().view(np.uint32)
        np.testing.assert_array_equal(got[0, :, 0], want)
        assert not got[0, :, 1:].any()
    model = model_relation_grid(rows, np.array([[0, 1]], dtype=np.int32), tile)
    np.testing.assert_array_equal(model[0, 0, :, 0], want)
    u8 = unpack_words_np(want[:, None], 70)[0]
    assert set(np.nonzero(u8)[0]) == {0, 1, 31, 32, 63, 69}


@pytest.mark.parametrize("case", list(synth.relation_edge_cases(
    np.zeros((1024, RULE_COLS), dtype=np.uint32))))
def test_relation_grid_on_every_edge_tile_equals_the_reference(rules2048, case):
    """Each edge tile as a one-tile work list, both ways round and against
    itself; the words unpack on the host and on the device alike."""
    ri, rj = synth.relation_edge_cases(rules2048)[case]
    t = max(ri.shape[0], rj.shape[0])
    blocks = bits(np.concatenate([overlap._pad_rows(ri, t), overlap._pad_rows(rj, t)]))
    work = torch.tensor([[0, 1], [1, 0], [1, 1]], dtype=torch.int32)
    words = torch.stack(overlap.relation_grid(blocks, work, t))
    for k, (a, b) in enumerate(((ri, rj), (rj, ri), (rj, rj))):
        want = roverlap.relation_tile(a, b)
        host = unpack_words_np(words[:, k].numpy(), b.shape[0])
        for m in (0, 1):
            dev = overlap.unpack_words(words[m, k], b.shape[0])
            np.testing.assert_array_equal(host[m, : a.shape[0]], np.asarray(want[m]))
            np.testing.assert_array_equal(dev.numpy()[: a.shape[0]], np.asarray(want[m]))
    (cov, ovl), (rcov, rovl) = tile_both(ri, rj)
    np.testing.assert_array_equal(cov, rcov)
    np.testing.assert_array_equal(ovl, rovl)


def test_pack_and_unpack_words_invert():
    rng = np.random.default_rng(11)
    for t, tj in ((1, 1), (5, 33), (64, 64), (70, 512)):
        rel = torch.from_numpy(rng.random((t, tj)) < 0.5)
        words = overlap.pack_words(rel)
        assert words.dtype == torch.int32 and words.shape == (overlap.words_of(tj), t)
        assert torch.equal(overlap.unpack_words(words, tj), rel)
        np.testing.assert_array_equal(unpack_words_np(words.numpy(), tj), rel.numpy())


@pytest.mark.parametrize("tile", [16, 64])
@pytest.mark.parametrize("lower_only", [False, True])
def test_pair_relations_many_equals_each_slab_alone(tile, lower_only):
    """Several slabs (one empty, one of a single row, ragged ones) in one
    schedule: each slab's matrices and on_tile order are the reference's
    pair_relations of that slab alone, slab after slab."""
    rng = np.random.default_rng(tile)
    slabs = [mixed_rules(1, 37), np.zeros((0, RULE_COLS), np.uint32), mixed_rules(2, 1),
             random_rules(rng, 100, n_acls=1), mixed_rules(3, 64)]
    calls = []
    got = list(overlap.pair_relations_many(
        slabs, tile=tile, lower_only=lower_only,
        on_tile=lambda s, i0, j0: calls.append((s, i0, j0))))
    want_calls = []
    for s, slab in enumerate(slabs):
        rcalls = []
        want = roverlap.pair_relations(slab, tile=tile, lower_only=lower_only,
                                       on_tile=lambda i0, j0: rcalls.append((i0, j0)))
        want_calls += [(s, i0, j0) for i0, j0 in rcalls]
        np.testing.assert_array_equal(got[s][0], want[0])
        np.testing.assert_array_equal(got[s][1], want[1])
    assert calls == want_calls


def test_pair_relations_many_launches_once_a_device(monkeypatch):
    """One relation_grid call a device that has tiles, none for no tiles, and
    every on_tile call before the first of them."""
    events = []
    real = overlap.relation_grid

    def spy(blocks, work, tile):
        events.append(("grid", blocks.device, work.shape[0]))
        return real(blocks, work, tile)

    monkeypatch.setattr(overlap, "relation_grid", spy)
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    slabs = [mixed_rules(4, 40), mixed_rules(5, 20)]
    got = list(overlap.pair_relations_many(slabs, tile=16, devices=devs,
                                           on_tile=lambda *a: events.append(("tile",) + a)))
    tiles = [e for e in events if e[0] == "tile"]
    grids = [e for e in events if e[0] == "grid"]
    assert events[: len(tiles)] == tiles and len(tiles) == 9 + 4
    # one call a device (a CPU tensor reports no index): i-blocks round
    # robin within each slab, slab 0's rows 0 and 32 and slab 1's row 0 on
    # device 0 (3 + 3 + 2 tiles), slab 0's 16 and slab 1's 16 on device 1
    assert [g[2] for g in grids] == [8, 5]
    for s, slab in enumerate(slabs):
        want = roverlap.pair_relations(slab, tile=16)
        np.testing.assert_array_equal(got[s][0], want[0])
        np.testing.assert_array_equal(got[s][1], want[1])
    events.clear()
    assert next(overlap.pair_relations_many([np.zeros((0, RULE_COLS), np.uint32)]))[0].shape \
        == (0, 0)
    assert events == []


@pytest.mark.parametrize("tile,lower_only", [(16, True), (16, False), (32, True)])
def test_pair_relations_many_unpacks_a_slab_at_a_time_in_bounded_chunks(monkeypatch, tile,
                                                                         lower_only):
    """The unpack's peak does not grow with the analysis: nothing is
    unpacked before its slab is asked for, and no unpack takes more than
    UNPACK_TILES tiles of the two matrices (here up to 190 tiles a slab)."""
    seen = []
    real = overlap.unpack_words

    def spy(words, n):
        seen.append(tuple(words.shape))
        return real(words, n)

    monkeypatch.setattr(overlap, "unpack_words", spy)
    slabs = [mixed_rules(7, 300), mixed_rules(8, 100), np.zeros((0, RULE_COLS), np.uint32),
             mixed_rules(9, 200)]
    it = overlap.pair_relations_many(slabs, tile=tile, lower_only=lower_only)
    assert seen == []  # launched; nothing unpacked yet
    for slab in slabs:
        seen.clear()
        cov, ovl = next(it)
        n = -(-slab.shape[0] // tile)
        n_tiles = n * (n + 1) // 2 if lower_only else n * n
        assert sum(w[1] for w in seen) == n_tiles
        assert all(w[0] == 2 and w[1] <= overlap.UNPACK_TILES and w[2:] == (1, tile)
                   for w in seen)
        assert len(seen) == -(-n_tiles // overlap.UNPACK_TILES)
        want = roverlap.pair_relations(slab, tile=tile, lower_only=lower_only)
        np.testing.assert_array_equal(cov, np.asarray(want[0]))
        np.testing.assert_array_equal(ovl, np.asarray(want[1]))
    assert next(it, None) is None


def test_relation_grid_refuses_what_the_kernel_does_not_take():
    blocks = bits(mixed_rules(6, 32))
    work = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        overlap.relation_grid(blocks.to(torch.int64), work, 16)
    with pytest.raises(ValueError, match="whole tiles"):
        overlap.relation_grid(blocks, work, 5)
    with pytest.raises(ValueError, match="positive"):
        overlap.relation_grid(blocks, work, 0)
    with pytest.raises(ValueError, match=r"\[n_tiles, 2\]"):
        overlap.relation_grid(blocks, work.to(torch.int64), 16)
    with pytest.raises(ValueError, match=r"\[n_tiles, 2\]"):
        overlap.relation_grid(blocks, work.reshape(2), 16)
    with pytest.raises(ValueError, match="outside"):
        overlap.relation_grid(blocks, torch.tensor([[0, 2]], dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="outside"):
        overlap.relation_grid(blocks, torch.tensor([[-1, 0]], dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="contiguous"):
        overlap.relation_grid(blocks, torch.tensor([[0, 1], [1, 0]], dtype=torch.int32).t(), 16)
    cov, ovl = overlap.relation_grid(blocks, work, 16)
    assert cov.shape == ovl.shape == (1, 1, 16) and cov.dtype == torch.int32
