"""Kernel 1's plain version (ops/first_match.py) against the reference.

The reference side is ``pallas_match.first_match_rows_pallas`` in
interpret mode and the plain ``ops.match.first_match_rows``, over the
cases of tests/test_pallas_match.py: several seeds, lines that match
nothing, a batch that is not a multiple of the block, and padding
columns that never match even all-zero lines.  Exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu.ops import pallas_match  # noqa: E402
from ruleset_analysis_tpu.ops.match import first_match_rows, match_keys  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import first_match  # noqa: E402
from ruleset_analysis_tpu_torch.ops import match as tmatch  # noqa: E402

NAMES = ["acl", "proto", "src", "sport", "dst", "dport"]


def _case(n_acls=3, rules_per_acl=24, n=2048, seed=0):
    cfg_text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=seed)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    tuples = synth.synth_tuples(packed, n, seed=seed + 1)
    return packed, tuples


def _fields(tuples):
    return [torch.from_numpy(np.ascontiguousarray(tuples[:, i]).view(np.int32)) for i in range(6)]


def _jcols(tuples):
    return {k: jnp.asarray(tuples[:, i]) for i, k in enumerate(NAMES)}


def _port_rows(packed, tuples):
    r = pipeline.ship_ruleset(packed, "cpu")
    return first_match.first_match_rows(_fields(tuples), r.rules_fm).numpy().view(np.uint32)


def _pallas_rows(packed, tuples, block_lines=512):
    fm = pallas_match.prep_rules(jnp.asarray(packed.rules))
    return np.asarray(
        pallas_match.first_match_rows_pallas(_jcols(tuples), fm, block_lines=block_lines, interpret=True)
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_match_pallas_and_xla(seed):
    packed, tuples = _case(seed=seed)
    got = _port_rows(packed, tuples)
    np.testing.assert_array_equal(got, _pallas_rows(packed, tuples))
    np.testing.assert_array_equal(
        got, np.asarray(first_match_rows(_jcols(tuples), jnp.asarray(packed.rules)))
    )


def test_no_match_lines_get_no_match():
    packed, tuples = _case(n=512, seed=5)
    tuples = tuples.copy()
    tuples[:, 0] = 0xFFFF  # a non-existent ACL gid never matches any rule
    got = _port_rows(packed, tuples)
    assert (got == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(got, _pallas_rows(packed, tuples))


def test_batch_not_multiple_of_block():
    packed, tuples = _case(n=700, seed=6)
    np.testing.assert_array_equal(_port_rows(packed, tuples), _pallas_rows(packed, tuples))


def test_padding_columns_never_match_zero_lines():
    packed, _ = _case(n_acls=4, rules_per_acl=64, seed=7)
    zero = np.zeros((512, 7), dtype=np.uint32)
    r = pipeline.ship_ruleset(packed, "cpu")
    assert r.rules_fm.shape[1] % first_match.RULE_TILE == 0
    assert (r.rules_fm[0, packed.rules.shape[0]:].numpy().view(np.uint32) == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(_port_rows(packed, zero), _pallas_rows(packed, zero))


def test_prep_rules_matches_reference():
    packed, _ = _case(n_acls=2, rules_per_acl=40, seed=3)
    r = pipeline.ship_ruleset(packed, "cpu")
    want = np.asarray(pallas_match.prep_rules(jnp.asarray(pipeline.pad_rules(packed.rules))))
    np.testing.assert_array_equal(r.rules_fm.numpy().view(np.uint32), want)


def test_match_keys_match_reference():
    packed, tuples = _case(n_acls=2, rules_per_acl=40, n=1024, seed=3)
    tuples = tuples.copy()
    tuples[::7, 0] = 9  # corrupt acl ids clamp onto the last ACL's deny key
    want = np.asarray(match_keys(
        _jcols(tuples), jnp.asarray(packed.rules), jnp.asarray(packed.deny_key.astype(np.uint32))
    ))
    r = pipeline.ship_ruleset(packed, "cpu")
    cols = dict(zip(NAMES, _fields(tuples)))
    got = first_match.match_keys(cols, r.rules, r.rules_fm, r.deny_key)
    np.testing.assert_array_equal(got.numpy(), want)
    cols64 = {k: first_match.u32_of(v) for k, v in cols.items()}
    plain = tmatch.match_keys(cols64, r.rules, r.deny_key, rule_block=128)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_wrapper_checks_its_inputs():
    packed, tuples = _case(n=64, seed=4)
    r = pipeline.ship_ruleset(packed, "cpu")
    f = _fields(tuples)
    with pytest.raises(ValueError, match="int32"):
        first_match.first_match_rows([x.to(torch.int64) for x in f], r.rules_fm)
    with pytest.raises(ValueError, match="one length"):
        first_match.first_match_rows(f[:5] + [f[5][:10]], r.rules_fm)
    with pytest.raises(ValueError, match="rules_fm"):
        first_match.first_match_rows(f, r.rules_fm[:, :100].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        first_match.first_match_rows(f[:5] + [torch.stack([f[5], f[5]], 1)[:, 0]], r.rules_fm)
