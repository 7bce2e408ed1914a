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
