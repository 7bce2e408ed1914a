"""Weighted rows: the port's coalescing against the reference's, bit for bit.

The compactors (native and numpy), the Coalescer's bucket ladder, auto
decision and summary, the weighted wire layout's unpack (weights at and
above 2^31 included), and the weight-aware register updates — HLL gates
on ``weight > 0``, the talker CMS and candidate table add the weight —
all equal the reference's on the same seeded inputs.  A coalesced run's
report equals the uncoalesced one.  The same holds for IPv6 rows: the v6
compactors and Coalescer hooks, the weighted v6 wire unpack, and a
dual-stack run with coalescing on, and over a coalesced v3 file with a v6
section.  A stacked-layout run with coalescing on gives the reference's
stacked report over v4 and dual-stack text.  Tolerance 0 everywhere.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as rpipe  # noqa: E402
from ruleset_analysis_tpu.ops import hll as jhll  # noqa: E402
from ruleset_analysis_tpu.ops import topk as jtopk  # noqa: E402
from ruleset_analysis_tpu.runtime import coalesce as rcoal  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import hll as thll  # noqa: E402
from ruleset_analysis_tpu_torch.ops.hashing import u32_of  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import coalesce  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream  # noqa: E402
from tests.test_torch_ops import talker_update  # noqa: E402


@pytest.fixture(scope="module")
def packed():
    text = synth.synth_config(n_acls=4, rules_per_acl=16, seed=4)
    return pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])


def _flows(packed, n, seed):
    t = synth.synth_flow_tuples(packed, n, 200, skew=1.2, seed=seed)
    return np.ascontiguousarray(t.T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compactors_equal_reference(packed, seed):
    batch = _flows(packed, 4000, seed)
    batch[pack.T_VALID, ::7] = 0  # invalid rows drop out
    got = pack.coalesce_batch(batch)
    assert (got == rpack.coalesce_batch(batch)).all()
    assert (got == pack._np_coalesce(batch)[0]).all()
    assert int(got[pack.T_VALID].sum()) == int(batch[pack.T_VALID].sum())
    assert got.shape[1] < 300
    wire = pack.compact_batch(batch)
    cw = pack.coalesce_wire(wire)
    assert cw.shape[0] == pack.WIREW_COLS and (cw == rpack.coalesce_wire(wire)).all()
    assert (cw == pack.compact_batch_w(got)).all()
    # composes: coalescing a weighted plane again merges nothing new
    assert (pack.coalesce_wire(cw) == cw).all()
    assert (pack.expand_batch(cw) == rpack.expand_batch(cw)).all()
    assert (pack.expand_batch(wire) == batch).all()
    assert (pack.pad_weighted(cw, 512) == rpack.pad_weighted(cw, 512)).all()


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("skew", [1.2, 0.0])
def test_coalescer_equals_reference(packed, mode, skew):
    b = 1024
    mine = coalesce.Coalescer(mode, b)
    ref = rcoal.Coalescer(mode, b, 1)
    assert mine._ladder == ref._ladder == [1024, 512, 256, 128, 64, 32]
    n_flows = 200 if skew else 1 << 16  # skew 0 over a large pool: few repeats
    for i in range(6):
        t = np.ascontiguousarray(
            synth.synth_flow_tuples(packed, b, n_flows, skew=skew, seed=i).T)
        if i % 2:
            got, want = mine.tuple4(t), ref.tuple4(t)
        else:
            got = mine.wire4(pack.compact_batch(t))
            want = ref.wire4(rpack.compact_batch(t))
        assert got.shape == want.shape and (got == want).all()
        assert mine.enabled() == ref.enabled()
    assert mine.summary() == ref.summary()
    assert mine.enabled() == (mode == "on" or skew > 0)


def test_make_coalescer_follows_the_config():
    assert coalesce.make_coalescer(AnalysisConfig(device="cpu"), 64) is None
    c = coalesce.make_coalescer(AnalysisConfig(device="cpu", coalesce="auto", match_impl="scan"),
                                64)
    assert c.mode == "auto" and c.enabled()


def test_weighted_wire_unpack_equals_reference(packed):
    t = _flows(packed, 3000, 5)
    w = pack.coalesce_wire(pack.compact_batch(t))
    w[pack.W_WEIGHT, :4] = np.array([1 << 31, (1 << 32) - 1, (1 << 31) + 5, 0], dtype=np.uint32)
    cols, valid = pipeline.batch_cols(torch.from_numpy(w.view(np.int32)))
    jcols, jvalid = rpipe.batch_cols(jnp.asarray(w))
    assert (u32_of(valid).numpy() == np.asarray(jvalid).astype(np.int64)).all()
    assert (u32_of(valid) >= 0).all() and int(u32_of(valid)[1]) == (1 << 32) - 1
    for k, v in cols.items():
        assert (u32_of(v).numpy() == np.asarray(jcols[k]).astype(np.int64)).all(), k


def test_weighted_register_updates_equal_reference(packed):
    rng = np.random.default_rng(8)
    n = 4096
    keys = rng.integers(0, 40, size=n).astype(np.uint32)
    src = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    acl = rng.integers(0, 4, size=n).astype(np.uint32)
    w = rng.integers(0, 6, size=n).astype(np.uint32)
    w[:3] = [1 << 31, (1 << 32) - 1, 0]

    def t(a):
        return torch.from_numpy(a.astype(np.int64))

    hll = thll.hll_update(thll.hll_init(40, 6, "cpu"), t(keys), t(src), t(w))
    jh = jhll.hll_update(jhll.hll_init(40, 6), jnp.asarray(keys), jnp.asarray(src),
                         jnp.asarray(w))
    assert (hll.numpy() == np.asarray(jh).astype(np.int64)).all()
    cms = torch.zeros((2, 1 << 12), dtype=torch.int64)
    got = talker_update(cms, acl, src, w, 64, salt=3)
    want = jtopk.talker_chunk_update(jnp.zeros((2, 1 << 12), jnp.uint32), jnp.asarray(acl),
                                     jnp.asarray(src), jnp.asarray(w), 64, salt=3)
    for g, x in zip(got, want):
        assert (g.numpy() == np.asarray(x).astype(np.int64)).all()


def test_fused_step_refuses_a_weighted_batch(packed):
    cfg = AnalysisConfig(device="cpu")
    rules = pipeline.ship_ruleset(packed, "cpu")
    state = pipeline.init_state(packed.n_keys, cfg, "cpu")
    w = pack.coalesce_wire(pack.compact_batch(_flows(packed, 256, 1)))
    batch = torch.from_numpy(pack.pad_weighted(w, 256).view(np.int32))
    with pytest.raises(ValueError, match="match_impl='scan'"):
        pipeline.analysis_step(state, rules, batch, n_keys=packed.n_keys, topk_k=8,
                               match_impl="fused")
    state, _ = pipeline.analysis_step(state, rules, batch, n_keys=packed.n_keys, topk_k=8,
                                      match_impl="scan")
    assert pipeline.counts_total(state) == 256


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_coalesced_run_equals_plain_run(packed, mode):
    lines = synth.render_syslog(packed, _flows(packed, 5000, 3).T, seed=3)
    plain = run_stream(packed, iter(lines), AnalysisConfig(batch_size=1000, device="cpu",
                                                           match_impl="scan"),
                       return_state=True)
    coal = run_stream(packed, iter(lines), AnalysisConfig(batch_size=1000, device="cpu",
                                                          match_impl="scan", coalesce=mode),
                      return_state=True)
    for k, v in plain[1].items():
        assert (coal[1][k] == v).all(), k
    assert coal[0].per_rule == plain[0].per_rule and coal[0].talkers == plain[0].talkers
    c = coal[0].totals["coalesce"]
    assert c["mode"] == mode and c["raw_rows"] == 5000 and c["unique_rows"] < 1200


@pytest.fixture(scope="module")
def packed6():
    text = synth.synth_config(n_acls=3, rules_per_acl=16, seed=6, v6_fraction=0.4)
    return pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])


def _flows6(packed6, n, n_flows, seed):
    """[TUPLE6_COLS, n] rows drawn with repetition from ``n_flows`` v6 tuples."""
    pool = synth.synth_tuples6(packed6, n_flows, seed=seed)
    idx = np.random.default_rng(seed).zipf(1.3, size=n) % n_flows
    return np.ascontiguousarray(pool[idx].T)


@pytest.mark.parametrize("seed", [0, 1])
def test_v6_compactors_and_coalescer_equal_reference(packed6, seed):
    b6 = _flows6(packed6, 2048, 150, seed)
    b6[pack.T6_VALID, ::9] = 0
    got = pack.coalesce_batch6(b6)
    assert (got == rpack.coalesce_batch6(b6)).all() and got.shape[1] < 200
    assert int(got[pack.T6_VALID].sum()) == int(b6[pack.T6_VALID].sum())
    w6 = pack.compact_batch6(b6)
    cw = pack.coalesce_wire6(w6)
    assert cw.shape[0] == pack.WIRE6W_COLS and (cw == rpack.coalesce_wire6(w6)).all()
    assert (pack.coalesce_wire6(cw) == cw).all()
    mine, ref = coalesce.Coalescer("on", 2048), rcoal.Coalescer("on", 2048, 1)
    assert (mine.tuple6(b6) == ref.tuple6(b6)).all()
    assert (mine.wire6(w6) == ref.wire6(w6)).all()
    assert mine.summary() == ref.summary()


def test_weighted_wire6_unpack_equals_reference(packed6):
    w = pack.coalesce_wire6(pack.compact_batch6(_flows6(packed6, 1024, 100, 3)))
    w[pack.W6_WEIGHT, :4] = np.array([1 << 31, (1 << 32) - 1, (1 << 31) + 5, 0], dtype=np.uint32)
    cols, valid = pipeline.batch_cols6(torch.from_numpy(w.view(np.int32)))
    jcols, jvalid = rpipe.batch_cols6(jnp.asarray(w))
    assert (u32_of(valid).numpy() == np.asarray(jvalid).astype(np.int64)).all()
    assert (u32_of(valid) >= 0).all() and int(u32_of(valid)[1]) == (1 << 32) - 1
    for k, v in cols.items():
        assert (u32_of(v).numpy() == np.asarray(jcols[k]).astype(np.int64)).all(), k


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_coalesced_dual_stack_run_equals_plain_run(packed6, mode):
    t4 = synth.synth_flow_tuples(packed6, 3000, 150, skew=1.2, seed=5)
    lines = synth.render_syslog(packed6, t4, seed=5)
    lines += synth.render_syslog6(packed6, _flows6(packed6, 2000, 120, 5).T, seed=6)
    np.random.default_rng(5).shuffle(lines)
    cfg = dict(batch_size=1000, device="cpu", match_impl="scan")
    plain = run_stream(packed6, iter(lines), AnalysisConfig(**cfg), return_state=True)
    coal = run_stream(packed6, iter(lines), AnalysisConfig(**cfg, coalesce=mode),
                      return_state=True)
    for k, v in plain[1].items():
        assert (coal[1][k] == v).all(), k
    assert coal[0].per_rule == plain[0].per_rule
    c = coal[0].totals["coalesce"]
    assert c["raw_rows"] == 5000 and c["unique_rows"] < 1500


def test_weighted_v6_wire_run_equals_reference(packed6, tmp_path):
    import json

    from ruleset_analysis_tpu.config import AnalysisConfig as JConfig
    from ruleset_analysis_tpu.hostside import aclparse as raclparse
    from ruleset_analysis_tpu.parallel.mesh import make_mesh
    from ruleset_analysis_tpu.runtime import stream as rstream
    from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS
    from ruleset_analysis_tpu_torch.hostside import wire
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_wire

    text = synth.synth_config(n_acls=3, rules_per_acl=16, seed=6, v6_fraction=0.4)
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(text, "fw1")])
    t4 = synth.synth_flow_tuples(packed6, 3000, 150, skew=1.2, seed=8)
    lines = synth.render_syslog(packed6, t4, seed=8)
    lines += synth.render_syslog6(packed6, _flows6(packed6, 2000, 120, 8).T, seed=9)
    np.random.default_rng(8).shuffle(lines)
    log = tmp_path / "l.log"
    log.write_text("\n".join(lines) + "\n")
    path = str(tmp_path / "w.rawire")
    stats = wire.convert_logs(packed6, [str(log)], path, coalesce=True, batch_size=1000)
    assert stats["weighted"] and stats["rows6"] and stats["evals"] == 5000
    rep = run_stream_wire(packed6, path, AnalysisConfig(batch_size=512, device="cpu",
                                                        match_impl="scan"), topk=5)
    jrep = rstream.run_stream_wire(rpacked, path, JConfig(batch_size=512), topk=5,
                                   mesh=make_mesh(jax.devices()[:1]))

    def strip(r):
        o = json.loads(r.to_json())
        for k in VOLATILE_TOTALS + ("backend",):
            o["totals"].pop(k, None)
        return o

    assert strip(rep) == strip(jrep)
    assert rep.totals["wire_evals"] == 5000 and sum(e["hits"] for e in rep.per_rule) == 5000


@pytest.mark.parametrize("family", ["v4", "v6"])
def test_stacked_coalesced_run_equals_reference(packed, packed6, family, tmp_path):
    """``--layout stacked --coalesce on``: each batch is compacted before it
    is bucketed by ACL, and grouped chunks cross weighted.  The Report
    equals the reference's same run (talkers included), over v4 and
    dual-stack text, under prefetch; registers equal the plain run's."""
    import json

    from ruleset_analysis_tpu.config import AnalysisConfig as JConfig
    from ruleset_analysis_tpu.hostside import aclparse as raclparse
    from ruleset_analysis_tpu.parallel.mesh import make_mesh
    from ruleset_analysis_tpu.runtime import stream as rstream
    from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS

    if family == "v4":
        p, text = packed, synth.synth_config(n_acls=4, rules_per_acl=16, seed=4)
        lines = synth.render_syslog(p, _flows(p, 4000, 7).T, seed=7)
    else:
        p, text = packed6, synth.synth_config(n_acls=3, rules_per_acl=16, seed=6,
                                              v6_fraction=0.4)
        lines = synth.render_syslog(p, synth.synth_flow_tuples(p, 2500, 150, skew=1.2, seed=7),
                                    seed=7)
        lines += synth.render_syslog6(p, _flows6(p, 1500, 120, 7).T, seed=8)
        np.random.default_rng(7).shuffle(lines)
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(text, "fw1")])
    kw = dict(batch_size=512, layout="stacked", coalesce="on", prefetch_depth=2)
    rep, regs = run_stream(p, iter(lines), AnalysisConfig(device="cpu", match_impl="scan",
                                                          **kw), topk=600, return_state=True)
    jrep = rstream.run_stream(rpacked, iter(lines), JConfig(**kw), topk=600,
                              mesh=make_mesh(jax.devices()[:1]))

    def strip(r):
        o = json.loads(r.to_json())
        for k in VOLATILE_TOTALS + ("backend",):
            o["totals"].pop(k, None)
        return o

    assert strip(rep) == strip(jrep)
    assert rep.totals["coalesce"]["unique_rows"] < rep.totals["coalesce"]["raw_rows"]
    _, plain = run_stream(p, iter(lines), AnalysisConfig(device="cpu", match_impl="scan",
                                                         batch_size=512), return_state=True)
    for k, v in plain.items():
        assert (regs[k] == v).all(), k
