"""The port's IPv6 first-match scan against the reference's and the oracle.

The v6 twin of test_torch_match.py, mirroring tests/test_match6.py on the
port: golden rows, 128-bit bounds that differ only in low limbs, the
implicit deny and ACL isolation, the blocked scan against one block,
randomized configs against the exact oracle, and ``fold_src32``.  Every
result is also held against the reference's ``ops/match6`` on the same
numpy inputs (tolerance 0).  Beside them: the kernel's row layout
(``first_match6.prep_rules6``) and its per-ACL span table against brute
force, the kernel wrapper's plain path, and the ``NO_ACL`` zero line,
which matches the first padding row as in the reference.
"""

import random

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import torch  # noqa: E402

from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import oracle as roracle  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.ops import match6 as rmatch6  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.syslog import ParsedLine  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import first_match, first_match6, match6  # noqa: E402
from ruleset_analysis_tpu_torch.ops.hashing import u32_of  # noqa: E402
from ruleset_analysis_tpu_torch.ops.match import NO_MATCH  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG6 = """\
hostname fw1
access-list OUT extended permit tcp any6 host 2001:db8::5 eq 443
access-list OUT extended permit tcp any6 host 2001:db8::5 eq 80
access-list OUT extended deny tcp any6 2001:db8:dead::/48
access-list OUT extended permit ip any6 any6
access-list DMZ extended permit udp 2001:db8:9::/64 any6 eq 53
"""


def make_packed(cfg=CFG6):
    rs = aclparse.parse_asa_config(cfg, "fw1")
    return pack.pack_rulesets([rs]), rs


def tuples6(rows):
    """rows of (gid, proto, src_int, sport, dst_int, dport, valid)."""
    out = np.zeros((len(rows), pack.TUPLE6_COLS), dtype=np.uint32)
    for i, (gid, proto, src, sport, dst, dport, valid) in enumerate(rows):
        out[i] = (gid, proto, *pack.u128_limbs(src), sport, *pack.u128_limbs(dst), dport, valid)
    return out


def port_cols(batch_np):
    """[n, TUPLE6_COLS] -> the port's int64 u32 columns (via batch_cols6)."""
    b = torch.from_numpy(np.ascontiguousarray(batch_np.T).view(np.int32))
    cols, _ = pipeline.batch_cols6(b)
    return {k: u32_of(v) for k, v in cols.items()}


def ref_cols(batch_np):
    b = jnp.asarray(np.ascontiguousarray(batch_np.T))
    cols = {"acl": b[rpack.T6_ACL], "proto": b[rpack.T6_PROTO], "sport": b[rpack.T6_SPORT],
            "dport": b[rpack.T6_DPORT]}
    for i in range(4):
        cols[f"src{i}"] = b[rpack.T6_SRC + i]
        cols[f"dst{i}"] = b[rpack.T6_DST + i]
    return cols


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def run_keys(packed, batch_np):
    """The port's keys, held against the reference's; returns key metas."""
    keys = match6.match_keys6(port_cols(batch_np), t64(packed.rules6), t64(packed.deny_key))
    want = rmatch6.match_keys6(ref_cols(batch_np), jnp.asarray(packed.rules6),
                               jnp.asarray(packed.deny_key))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))
    return [packed.key_meta[int(k)] for k in keys]


def kernel_rows(packed, batch_np):
    """Rows through the kernel wrapper's plain path (CPU tensors), as u32."""
    r6 = pipeline.ship_ruleset6(packed, "cpu")
    b = torch.from_numpy(np.ascontiguousarray(batch_np.T).view(np.int32))
    cols, _ = pipeline.batch_cols6(b)
    rows = first_match6.first_match_rows6([cols[k] for k in match6.FIELDS6], r6.rules_k6,
                                          r6.acl_span6)
    return u32_of(rows), r6


def test_first_match6_golden():
    packed, _ = make_packed()
    gid = packed.acl_gid[("fw1", "OUT")]
    ip6 = aclparse.ip6_to_int
    batch = tuples6([
        (gid, 6, ip6("2001:db8::9"), 999, ip6("2001:db8::5"), 443, 1),
        (gid, 6, ip6("2001:db8::9"), 999, ip6("2001:db8::5"), 80, 1),
        (gid, 6, ip6("2001:db8::9"), 80, ip6("2001:db8:dead:beef::1"), 80, 1),
        (gid, 17, ip6("::1"), 53, ip6("2001:4860::8888"), 53, 1),
    ])
    metas = run_keys(packed, batch)
    assert [m.index for m in metas] == [1, 2, 3, 4]
    rows, _ = kernel_rows(packed, batch)
    assert rows.tolist() == [0, 1, 2, 3]


def test_lexicographic_bounds_cross_limbs():
    """Range bounds that differ only in low limbs must compare correctly."""
    cfg = (
        "object network R\n"
        " range 2001:db8::ffff:ffff 2001:db8:0:1::2\n"
        "access-list A extended permit ip object R any6\n"
    )
    packed, _ = make_packed(cfg)
    gid = packed.acl_gid[("fw1", "A")]
    ip6 = aclparse.ip6_to_int
    inside = [ip6("2001:db8::ffff:ffff"), ip6("2001:db8:0:1::"), ip6("2001:db8:0:1::2")]
    outside = [ip6("2001:db8::ffff:fffe"), ip6("2001:db8:0:1::3"), 0, (1 << 128) - 1]
    batch = tuples6([(gid, 6, s, 1, ip6("::2"), 2, 1) for s in inside + outside])
    metas = run_keys(packed, batch)
    assert [m.index for m in metas[: len(inside)]] == [1] * len(inside)
    assert all(m.implicit_deny for m in metas[len(inside):])
    rows, _ = kernel_rows(packed, batch)
    assert rows.tolist() == [0] * len(inside) + [NO_MATCH] * len(outside)


def test_implicit_deny6_and_acl_isolation():
    packed, _ = make_packed()
    gid_dmz = packed.acl_gid[("fw1", "DMZ")]
    ip6 = aclparse.ip6_to_int
    # UDP from outside DMZ's source prefix: would hit OUT's any6/any6 if
    # the ACL gid were not checked
    batch = tuples6([(gid_dmz, 17, ip6("2001:db8:bad::1"), 53, ip6("::9"), 53, 1)])
    metas = run_keys(packed, batch)
    assert metas[0].implicit_deny and metas[0].acl == "DMZ"
    rows, _ = kernel_rows(packed, batch)
    assert rows.tolist() == [NO_MATCH]


def test_scan_path6_equals_single_block():
    """The blocked rule-axis scan equals the unblocked result (and the reference's)."""
    rng = random.Random(7)
    lines = ["hostname fw1"]
    for i in range(40):
        lines.append(f"access-list A extended permit tcp any6 2001:db8:{i:x}::/48 eq {1000 + i}")
    lines.append("access-list A extended deny ip any6 any6")
    packed, _ = make_packed("\n".join(lines) + "\n")
    gid = packed.acl_gid[("fw1", "A")]
    ip6 = aclparse.ip6_to_int
    rows = []
    for _ in range(200):
        i = rng.randrange(48)
        dst = ip6(f"2001:db8:{i % 44:x}::{rng.randrange(1, 1 << 16):x}")
        rows.append((gid, 6, rng.getrandbits(128), rng.randrange(1 << 16), dst,
                     1000 + rng.randrange(44), 1))
    batch = tuples6(rows)
    r6 = packed.rules6
    r6p = pipeline.pad_rules6(r6, 8)
    a = match6.first_match_rows6(port_cols(batch), t64(r6p), rule_block=8)
    b = match6.first_match_rows6(port_cols(batch), t64(r6), rule_block=len(r6) + 1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = rmatch6.first_match_rows6(ref_cols(batch), jnp.asarray(r6p), rule_block=8)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want).astype(np.int64))


def _rand_v6_cfg(rng, n_acls=3, rules_per_acl=12):
    """Random mixed config exercising hosts/prefixes/ranges/ports/any6."""
    lines = ["hostname fw1"]
    prefixes = [f"2001:db8:{i:x}::" for i in range(8)]

    def addr():
        r = rng.random()
        if r < 0.3:
            return f"host {rng.choice(prefixes)}{rng.randrange(1, 200):x}"
        if r < 0.7:
            return f"{rng.choice(prefixes)}/{rng.choice([44, 48, 64, 96, 126])}"
        return "any6"

    def ports():
        r = rng.random()
        if r < 0.4:
            return f" eq {rng.randrange(1, 1024)}"
        if r < 0.6:
            lo = rng.randrange(1, 60000)
            return f" range {lo} {lo + rng.randrange(1, 1000)}"
        return ""

    for a in range(n_acls):
        for _ in range(rules_per_acl):
            action = rng.choice(["permit", "deny"])
            proto = rng.choice(["tcp", "udp", "ip"])
            p = ports() if proto != "ip" else ""
            lines.append(f"access-list ACL{a} extended {action} {proto} {addr()} {addr()}{p}")
        lines.append(f"access-list ACL{a} extended deny ip any6 any6")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [3, 17, 99])
def test_match6_agrees_with_oracle_randomized(seed):
    rng = random.Random(seed)
    cfg = _rand_v6_cfg(rng)
    packed, _ = make_packed(cfg)
    orc = roracle.Oracle([raclparse.parse_asa_config(cfg, "fw1")])
    gids = {g: (fw, acl) for (fw, acl), g in packed.acl_gid.items()}
    prefixes = [aclparse.ip6_to_int(f"2001:db8:{i:x}::") for i in range(8)]
    rows, expect = [], []
    for _ in range(600):
        gid = rng.randrange(packed.n_acls)
        fw, acl = gids[gid]
        proto = rng.choice([6, 17, 58, 0])
        src = rng.choice(prefixes) + rng.getrandbits(rng.choice([16, 64, 128 - 36]))
        dst = rng.choice(prefixes) + rng.getrandbits(rng.choice([16, 64]))
        sport, dport = rng.randrange(1 << 16), rng.randrange(1 << 16)
        src &= (1 << 128) - 1
        from ruleset_analysis_tpu.hostside.syslog import ParsedLine as RParsedLine

        p = RParsedLine(firewall=fw, acl=acl, ingress_if=None, proto=proto, src=src,
                        sport=sport, dst=dst, dport=dport, permitted=None, family=6)
        (ek,) = orc.match_keys(p)
        expect.append(ek)
        rows.append((gid, proto, src, sport, dst, dport, 1))
    batch = tuples6(rows)
    metas = run_keys(packed, batch)
    assert [(m.firewall, m.acl, m.index) for m in metas] == expect
    # the kernel wrapper's plain path (span table as a mask) gives the same rows
    got, _ = kernel_rows(packed, batch)
    want = match6.first_match_rows6(port_cols(batch), t64(pipeline.pad_rules6(packed.rules6)))
    assert torch.equal(got, want)


def test_port_oracle_matches_v6_lines():
    """The port's own oracle copy agrees with the scan on v6 ParsedLines."""
    from ruleset_analysis_tpu_torch.hostside import oracle

    rng = random.Random(5)
    cfg = _rand_v6_cfg(rng, n_acls=2, rules_per_acl=8)
    packed, rs = make_packed(cfg)
    orc = oracle.Oracle([rs])
    gids = {g: (fw, acl) for (fw, acl), g in packed.acl_gid.items()}
    base = aclparse.ip6_to_int("2001:db8::")
    rows, expect = [], []
    for _ in range(300):
        gid = rng.randrange(packed.n_acls)
        src = base + rng.getrandbits(rng.choice([16, 64, 90]))
        dst = base + rng.getrandbits(rng.choice([16, 64]))
        proto, sport, dport = rng.choice([6, 17]), rng.randrange(1 << 16), rng.randrange(1024)
        p = ParsedLine(firewall=gids[gid][0], acl=gids[gid][1], ingress_if=None, proto=proto,
                       src=src, sport=sport, dst=dst, dport=dport, permitted=None, family=6)
        (ek,) = orc.match_keys(p)
        expect.append(ek)
        rows.append((gid, proto, src, sport, dst, dport, 1))
    metas = run_keys(packed, tuples6(rows))
    assert [(m.firewall, m.acl, m.index) for m in metas] == expect


def test_fold_src32_equals_reference_and_host():
    rng = random.Random(1)
    vals = [rng.getrandbits(128) for _ in range(2000)] + [0, (1 << 128) - 1, 1 << 127]
    batch = tuples6([(0, 6, v, 1, 0, 2, 1) for v in vals])
    f1 = match6.fold_src32(port_cols(batch)).numpy()
    np.testing.assert_array_equal(f1, match6.fold_src32(port_cols(batch)).numpy())
    np.testing.assert_array_equal(f1, np.asarray(rmatch6.fold_src32(ref_cols(batch))))
    np.testing.assert_array_equal(f1, [pack.fold_src32_host(v) for v in vals])
    limbs = np.ascontiguousarray(batch[:, pack.T6_SRC:pack.T6_SRC + 4].T)
    np.testing.assert_array_equal(f1, pack.fold_src32_np(limbs))
    assert (f1 >= 0).all() and (f1 < 1 << 32).all()
    # 2000 random 128-bit values: expect no 32-bit collisions (p ~ 5e-4)
    assert len(set(f1[:2000].tolist())) == 2000


def test_kernel_layout_roundtrips_and_spans_equal_brute_force():
    text = synth.synth_config(n_acls=5, rules_per_acl=30, seed=2, v6_fraction=0.4)
    packed, _ = make_packed(text)
    r6 = pipeline.ship_ruleset6(packed, "cpu")
    assert r6.rules_k6.dtype == torch.int32 and r6.rules_k6.shape[1] == pack.RULE6_COLS
    assert r6.rules_k6.shape[0] % first_match.RULE_TILE == 0
    assert torch.equal(first_match6.plain_rules6(r6.rules_k6)[: r6.rules6.shape[0]], r6.rules6)
    # scalar hi slots hold hi - lo; address bounds stay lo and hi
    k = u32_of(r6.rules_k6)
    n = packed.rules6.shape[0]
    assert (k[:n, 2].numpy() == (packed.rules6[:, pack.R6_PHI] - packed.rules6[:, pack.R6_PLO])).all()
    assert (k[:n, 8:12].numpy() == packed.rules6[:, pack.R6_SLO:pack.R6_SLO + 4]).all()
    # the span table against brute force, padding acl included
    acl = k[:, 0].tolist()
    span = r6.acl_span6.tolist()
    a = len(span) - 1
    assert a == packed.n_acls
    for g in range(a):
        mine = [i for i, x in enumerate(acl) if x == g]
        assert span[g] == ([mine[0], mine[-1] + 1] if mine else [0, 0]), g
    pad = [i for i, x in enumerate(acl) if x == NO_MATCH]
    assert span[a] == [pad[0], pad[-1] + 1] == [n, k.shape[0]]


def test_no_acl_zero_line_takes_the_first_padding_row():
    """A line with acl 0xFFFFFFFF and every other field 0 matches the first
    NO_ACL padding row, in the port and in the reference (tuple layout
    only: the wire-v2 acl has 23 bits and cannot spell it)."""
    packed, _ = make_packed()
    ip6 = aclparse.ip6_to_int
    gid = packed.acl_gid[("fw1", "OUT")]
    batch = tuples6([(0xFFFFFFFF, 0, 0, 0, 0, 0, 0),
                     (0xFFFFFFFF, 6, 0, 0, 0, 0, 0),
                     (gid, 6, ip6("2001:db8::9"), 999, ip6("2001:db8::5"), 443, 1)])
    r6p = pipeline.pad_rules6(packed.rules6)
    n = packed.rules6.shape[0]
    got = match6.first_match_rows6(port_cols(batch), t64(r6p))
    want = rmatch6.first_match_rows6(ref_cols(batch), jnp.asarray(r6p))
    assert got.tolist() == np.asarray(want).astype(np.int64).tolist() == [n, NO_MATCH, 0]
    rows, _ = kernel_rows(packed, batch)
    assert rows.tolist() == [n, NO_MATCH, 0]


def test_wrapper_refuses_bad_inputs():
    packed, _ = make_packed()
    r6 = pipeline.ship_ruleset6(packed, "cpu")
    fields = [torch.zeros(4, dtype=torch.int32) for _ in match6.FIELDS6]
    with pytest.raises(ValueError, match="12 v6 line fields"):
        first_match6.first_match_rows6(fields[:6], r6.rules_k6, r6.acl_span6)
    with pytest.raises(ValueError, match="int32"):
        first_match6.first_match_rows6([f.long() for f in fields], r6.rules_k6, r6.acl_span6)
    with pytest.raises(ValueError, match="rules_k"):
        first_match6.first_match_rows6(fields, r6.rules_k6[:, :12].contiguous(), r6.acl_span6)
    assert first_match6.first_match_rows6(fields, r6.rules_k6, r6.acl_span6).shape == (4,)


def _span_lengths(rules6):
    """Row count of each ACL's span (padding rows left out) after padding."""
    span = first_match.acl_spans(first_match6.prep_rules6(t64(pipeline.pad_rules6(rules6))))
    return (span[:-1, 1] - span[:-1, 0]).numpy()


@pytest.mark.parametrize("name,shape", [
    ("one ACL of 8300 v6 rows, first hits deep", lambda r, n: n.max() >= 8192),
    ("interleaved ACL rows",  # every span holds rows of other ACLs
     lambda r, n: (n > (r[:, 0][:, None] == np.arange(len(n))).sum(0)).all()),
    ("every line unmatched in a 1000-row ACL", lambda r, n: 1000 in n),
    ("spans not multiples of 8, 16 or 32", lambda r, n: (n[n > 0] % 8 != 0).all() and n.max() > 32),
])
def test_edge_cases_have_the_shapes_they_name(name, shape):
    """The synthetic v6 edge rulesets reach the kernel's long walks (many
    group steps a line), spans holding other ACLs' rows (the acl compared
    inside the span), whole-span walks, and a group's ragged last step."""
    rules6, _ = synth.match6_edge_cases(n=1)[name]
    assert shape(rules6, _span_lengths(rules6)), name


EDGE_CASES = list(synth.match6_edge_cases(n=1))


@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_cases_equal_reference(name):
    """synth.match6_edge_cases (the shapes the card holds the kernel to) through
    the wrapper's plain path equal the reference's scan."""
    rules6, t6 = synth.match6_edge_cases(n=700, seed=5)[name]
    r6p = pipeline.pad_rules6(rules6)
    rk = first_match6.prep_rules6(t64(r6p))
    span = first_match.acl_spans(rk)
    b = torch.from_numpy(np.ascontiguousarray(t6.T).view(np.int32))
    cols, _ = pipeline.batch_cols6(b)
    got = u32_of(first_match6.first_match_rows6([cols[k] for k in match6.FIELDS6], rk, span))
    want = rmatch6.first_match_rows6(ref_cols(t6), jnp.asarray(r6p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    if name.startswith("ragged"):
        assert (got[7::31] == rules6.shape[0]).all()  # the first padding row
    if name.startswith("an ACL with no"):
        assert (got[t6[:, 0] == 1] == NO_MATCH).all() and int(span[1, 1]) == 0
    if name.startswith("every line unmatched"):
        assert (got == NO_MATCH).all()
    if name.startswith("one ACL of 8300"):  # hits deep in the span, and some lines walk it all
        hit = got[(t6[:, 0] == 0) & (got != NO_MATCH).numpy()]
        assert hit.numel() and (hit >= 4150).all() and (hit < 8300).all()
        assert ((t6[:, 0] == 0) & (got == NO_MATCH).numpy()).any()
