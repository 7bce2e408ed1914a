"""The per-ACL row-span table and the span-masked plain match versions.

``first_match.acl_spans`` is held against a brute-force numpy reckoning
over random rule tensors: interleaved ACLs, ACLs with no rows, acl ids
beyond n_acls, NO_ACL rows mid-table and as padding.  The plain versions
of both kernels, which take the table and use it as a mask, are held
against the reference's Pallas kernels (interpret mode) and its plain
``ops.match.first_match_rows`` over ``synth.match_edge_cases``, with
tolerance 0.  Inputs are made from seeds with numpy.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.models.pipeline import pad_rules as ref_pad_rules  # noqa: E402
from ruleset_analysis_tpu.ops import pallas_fused, pallas_match  # noqa: E402
from ruleset_analysis_tpu.ops.match import first_match_rows as ref_first_match_rows  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import synth  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import NO_ACL, R_ACL  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import first_match, match_hist  # noqa: E402

NAMES = ["acl", "proto", "src", "sport", "dst", "dport"]
CASES = synth.match_edge_cases(n=1024, seed=11)


def _spans_np(acl: np.ndarray) -> np.ndarray:
    """Brute force: first and one-past-last row of every acl id, NO_ACL last."""
    acl = acl.astype(np.int64)
    pad = acl == int(NO_ACL)
    a = max(int(acl[~pad].max()) + 1 if (~pad).any() else 0, 1)
    out = np.zeros((a + 1, 2), dtype=np.int32)
    for k in range(a + 1):
        rows = np.nonzero(pad if k == a else acl == k)[0]
        if len(rows):
            out[k] = rows[0], rows[-1] + 1
    return out


def _device_rules(rules: np.ndarray):
    padded = torch.from_numpy(pipeline.pad_rules(rules).astype(np.int64))
    rk = first_match.prep_rules(padded)
    return padded, rk, first_match.acl_spans(rk)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _random_acl_column(kind: str, rng) -> np.ndarray:
    if kind == "interleaved":
        return rng.integers(0, 7, size=700).astype(np.uint32)
    if kind == "empty ACLs and NO_ACL mid-table":
        acl = np.repeat(np.array([1, 4, NO_ACL, 4, 12], dtype=np.uint32), [30, 3, 9, 40, 17])
        return rng.permutation(acl) if rng.random() < 0.5 else acl
    if kind == "ids beyond n_acls":
        return np.concatenate([np.zeros(20, np.uint32), np.full(5, 70000, np.uint32)])
    if kind == "only padding":
        return np.full(3, NO_ACL, dtype=np.uint32)
    raise AssertionError(kind)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "kind", ["interleaved", "empty ACLs and NO_ACL mid-table", "ids beyond n_acls", "only padding"]
)
def test_span_table_equals_brute_force(kind, seed):
    rng = np.random.default_rng(seed)
    rules = synth.synth_rule_rows(_random_acl_column(kind, rng), seed=seed)
    _, rk, span = _device_rules(rules)
    want = _spans_np(rk[:, R_ACL].numpy().view(np.uint32))
    assert span.dtype == torch.int32 and span.is_contiguous()
    np.testing.assert_array_equal(span.numpy(), want)
    # the padding entry covers pad_rules' NO_ACL rows
    assert span[-1, 1] == rk.shape[0]


def test_span_table_of_a_packed_ruleset():
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack

    text = synth.synth_config(n_acls=5, rules_per_acl=30, seed=2)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    r = pipeline.ship_ruleset(packed, "cpu")
    span = r.acl_span.numpy()
    assert span.shape == (packed.n_acls + 1, 2)
    np.testing.assert_array_equal(span, _spans_np(r.rules_k[:, R_ACL].numpy().view(np.uint32)))
    # pack.py emits each ACL's rows contiguously, in gid order
    assert (span[1:-1, 0] == span[:-2, 1]).all() and span[0, 0] == 0
    assert span[-2, 1] == packed.rules.shape[0] and span[-1, 0] == packed.rules.shape[0]


def _reference(rules, tuples, n_acls):
    padded = jnp.asarray(ref_pad_rules(rules))
    fm = pallas_match.prep_rules(padded)
    cols = {k: jnp.asarray(tuples[:, i]) for i, k in enumerate(NAMES)}
    valid = jnp.asarray(tuples[:, 6])
    rows_pallas = pallas_match.first_match_rows_pallas(cols, fm, interpret=True)
    rows_xla = ref_first_match_rows(cols, padded)
    row, hr, hd = pallas_fused.match_rows_and_hists_pallas(cols, valid, fm, n_acls, interpret=True)
    return [np.asarray(x) for x in (rows_pallas, rows_xla, row, hr, hd)]


def _port(rules, tuples, n_acls):
    _, rk, span = _device_rules(rules)
    fields = [_i32(tuples[:, i]) for i in range(6)]
    rows = first_match.first_match_rows(fields, rk, span)
    row, hr, hd = match_hist.match_rows_and_hists(fields, _i32(tuples[:, 6]), rk, span, n_acls)
    return [x.numpy().view(np.uint32) for x in (rows, row, hr, hd)]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_equal_the_reference_on_edge_cases(name):
    rules, tuples, n_acls = CASES[name]
    rows, row, hr, hd = _port(rules, tuples, n_acls)
    pallas_rows, xla_rows, ref_row, ref_hr, ref_hd = _reference(rules, tuples, n_acls)
    np.testing.assert_array_equal(rows, pallas_rows, err_msg="first_match vs pallas_match")
    np.testing.assert_array_equal(rows, xla_rows, err_msg="first_match vs ops.match")
    np.testing.assert_array_equal(row, ref_row, err_msg="match_hist rows vs pallas_fused")
    np.testing.assert_array_equal(hr, ref_hr, err_msg="hist_rows vs pallas_fused")
    np.testing.assert_array_equal(hd, ref_hd, err_msg="hist_deny vs pallas_fused")
    assert int(hr.sum()) + int(hd.sum()) == int(tuples[:, 6].sum())


def test_no_acl_zero_line_matches_the_first_padding_row():
    rules, tuples, n_acls = CASES["interleaved ACLs"]
    zero = tuples[7::31]
    assert (zero[:, 0] == NO_ACL).all() and (zero[:, 1:6] == 0).all()
    rows, row, _, _ = _port(rules, tuples, n_acls)
    first_pad = rules.shape[0]  # 900 rows, padded to 1024 by pad_rules
    assert (rows[7::31] == first_pad).all() and (row[7::31] == first_pad).all()
    np.testing.assert_array_equal(rows, _reference(rules, tuples, n_acls)[0])


def test_without_padding_rows_the_no_acl_line_matches_nothing():
    rules, tuples, n_acls = CASES["one ACL of 7680 rows"]
    assert pipeline.pad_rules(rules).shape[0] == rules.shape[0]  # 15 x 512: no padding
    rows = _port(rules, tuples, n_acls)[0]
    assert (rows[7::31] == 0xFFFFFFFF).all()


def test_corrupt_acl_ids_match_nothing():
    rules, tuples, n_acls = CASES["odd spans"]
    rows = _port(rules, tuples, n_acls)[0]
    for bad in (n_acls + 3, 0xFFFFFFF0):
        lines = tuples[:, 0] == bad
        assert lines.sum() > 10 and (rows[lines] == 0xFFFFFFFF).all()


def test_a_wrong_span_table_shows_against_the_reference():
    rules, tuples, n_acls = CASES["odd spans"]
    _, rk, span = _device_rules(rules)
    fields = [_i32(tuples[:, i]) for i in range(6)]
    want = _reference(rules, tuples, n_acls)[0]
    np.testing.assert_array_equal(
        first_match.first_match_rows(fields, rk, span).numpy().view(np.uint32), want)
    short = span.clone()
    short[4, 0] += 1  # drop ACL 4's first row from its span
    got = first_match.first_match_rows(fields, rk, short).numpy().view(np.uint32)
    assert (got != want).any()
    hit_first = want == int(span[4, 0])
    assert hit_first.any() and (got[hit_first] != want[hit_first]).all()


def test_wrappers_refuse_a_bad_span_table():
    rules, tuples, n_acls = CASES["odd spans"]
    _, rk, span = _device_rules(rules)
    f = [_i32(tuples[:, i]) for i in range(6)]
    for bad in (span.to(torch.int64), span.T.contiguous(), span.T, span[:1], span.flatten(),
                span.flatten()[1:-1].reshape(-1, 2)):
        with pytest.raises(ValueError, match="acl_span"):
            first_match.first_match_rows(f, rk, bad)
        with pytest.raises(ValueError, match="acl_span"):
            match_hist.match_rows_and_hists(f, f[0], rk, bad, n_acls)


def test_span_table_refuses_acl_ids_beyond_the_wire_limit():
    rules = synth.synth_rule_rows(np.array([0, 1 << 23], dtype=np.uint32))
    with pytest.raises(ValueError, match="ACLs"):
        _device_rules(rules)
