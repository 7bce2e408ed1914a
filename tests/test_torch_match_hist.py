"""Kernel 2's plain version (ops/match_hist.py) against the reference.

The reference side is ``pallas_fused.match_rows_and_hists_pallas`` and
``match_keys_and_counts_pallas`` in interpret mode, over the cases of
tests/test_pallas_fused.py: invalid lines, corrupt acl ids, all-zero
lines, a batch that is not a multiple of the block, and padding.
Exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu.models.pipeline import pad_rules  # noqa: E402
from ruleset_analysis_tpu.ops import pallas_fused, pallas_match  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import match_hist, reg_tail  # noqa: E402

NAMES = ["acl", "proto", "src", "sport", "dst", "dport"]


def _case(n_acls=3, rules_per_acl=24, n=2048, seed=0, invalidate_every=0, corrupt_every=0):
    cfg_text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=seed)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    tuples = synth.synth_tuples(packed, n, seed=seed + 1)
    valid = np.ones(n, dtype=np.uint32)
    if invalidate_every:
        valid[::invalidate_every] = 0
    if corrupt_every:
        tuples[::corrupt_every, 0] = np.uint32(0xFFFFFFF0)
    return packed, tuples, valid


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _reference(packed, tuples, valid, block_lines=512):
    # padded as the reference's ship_ruleset pads them (RULE_BLOCK rows)
    rules = jnp.asarray(pad_rules(packed.rules))
    fm = pallas_match.prep_rules(rules)
    cols = {k: jnp.asarray(tuples[:, i]) for i, k in enumerate(NAMES)}
    deny = jnp.asarray(packed.deny_key.astype(np.uint32))
    row, hr, hd = pallas_fused.match_rows_and_hists_pallas(
        cols, jnp.asarray(valid), fm, deny.shape[0], block_lines=block_lines, interpret=True
    )
    keys, delta = pallas_fused.match_keys_and_counts_pallas(
        cols, jnp.asarray(valid), rules, fm, deny, packed.n_keys,
        block_lines=block_lines, interpret=True,
    )
    return [np.asarray(x) for x in (row, hr, hd, keys, delta)]


def _port(packed, tuples, valid):
    r = pipeline.ship_ruleset(packed, "cpu")
    fields = [_i32(tuples[:, i]) for i in range(6)]
    row, hr, hd = match_hist.match_rows_and_hists(
        fields, _i32(valid), r.rules_k, r.acl_span, r.deny_key.shape[0]
    )
    keys = reg_tail.line_keys(row, fields[0], r.key_k, r.rules_k.shape[0])
    delta = match_hist.counts_from_hists(hr, hd, r.rules, r.deny_key, packed.n_keys)
    u = [x.numpy().view(np.uint32) for x in (row, hr, hd)]
    return u + [keys.numpy(), delta.numpy()]


def _check(packed, tuples, valid):
    got, want = _port(packed, tuples, valid), _reference(packed, tuples, valid)
    for name, g, w in zip(("row", "hist_rows", "hist_deny", "keys", "delta"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[4].sum()) == int(valid.sum())  # every valid line counted once


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_rows_hists_keys_and_delta(seed):
    _check(*_case(seed=seed))


def test_invalid_lines_fall_out_of_both_histograms():
    _check(*_case(n=1024, seed=2, invalidate_every=3))


def test_corrupt_acl_ids_clamp_to_the_last_acl():
    packed, tuples, valid = _case(n=1024, seed=8, corrupt_every=5, invalidate_every=7)
    _check(packed, tuples, valid)


def test_all_zero_lines():
    packed, _, valid = _case(n_acls=2, rules_per_acl=8, n=512, seed=4)
    _check(packed, np.zeros((512, 7), dtype=np.uint32), valid)


def test_all_invalid_lines_count_nothing():
    packed, tuples, _ = _case(n=300, seed=9)
    _check(packed, tuples, np.zeros(300, dtype=np.uint32))


def test_batch_not_multiple_of_block():
    _check(*_case(n=700, seed=6))


def test_deny_histogram_is_lane_padded():
    packed, tuples, valid = _case(n_acls=4, rules_per_acl=64, n=512, seed=7)
    got = _port(packed, tuples, valid)
    assert got[1].shape[0] % 128 == 0 and got[2].shape[0] == 128
