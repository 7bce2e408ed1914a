"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips with a
reason when no CUDA device is present (decided when the test runs, never
at import).  Run on a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth
from ruleset_analysis_tpu_torch.models import pipeline
from ruleset_analysis_tpu_torch.ops import first_match, match_hist

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine with -m gpu)")
    return torch.device("cuda")


def _case(n_acls, rules_per_acl, n, seed=0):
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=seed)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    tuples = synth.synth_tuples(packed, n, seed=seed + 1)
    return packed, tuples


def _fields(tuples, dev):
    return [torch.from_numpy(np.ascontiguousarray(tuples[:, i]).view(np.int32)).to(dev)
            for i in range(7)]


@pytest.mark.parametrize("n_acls,rules,n", [(3, 24, 2048), (4, 64, 1000), (16, 256, 4099)])
def test_first_match_kernel_equals_plain(cuda, n_acls, rules, n):
    packed, tuples = _case(n_acls, rules, n)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)[:6]
    before = first_match.first_match_rows.launches
    got = first_match.first_match_rows(f, r.rules_k, r.acl_span)
    torch.cuda.synchronize()
    assert first_match.first_match_rows.launches == before + 1
    assert torch.equal(got, first_match.first_match_rows_plain(f, r.rules_k, r.acl_span))


@pytest.mark.parametrize("force_global", [False, True])
@pytest.mark.parametrize("n_acls,rules,n", [(3, 24, 2048), (16, 256, 4099)])
def test_match_hist_kernel_equals_plain(cuda, n_acls, rules, n, force_global):
    packed, tuples = _case(n_acls, rules, n)
    tuples[::5, 6] = 0  # invalid lines
    tuples[::11, 0] = 0xFFFFFFF0  # corrupt acl ids
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)
    got = match_hist.match_rows_and_hists(f[:6], f[6], r.rules_k, r.acl_span, packed.n_acls,
                                          force_global=force_global)
    torch.cuda.synchronize()
    want = match_hist.match_rows_and_hists_plain(f[:6], f[6], r.rules_k, r.acl_span,
                                                 packed.n_acls)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


EDGE_CASES = list(synth.match_edge_cases(n=1))


@pytest.mark.parametrize("force_global", [False, True])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_kernels_equal_plain_on_edge_cases(cuda, name, force_global):
    rules, tuples, n_acls = synth.match_edge_cases(n=4099, seed=3)[name]
    padded = torch.from_numpy(pipeline.pad_rules(rules).astype(np.int64))
    rk = first_match.prep_rules(padded).to(cuda)
    span = first_match.acl_spans(rk)
    assert torch.equal(span.cpu(), first_match.acl_spans(rk.cpu()))
    f = _fields(tuples, cuda)
    got = first_match.first_match_rows(f[:6], rk, span)
    torch.cuda.synchronize()
    want = first_match.first_match_rows_plain(f[:6], rk, span)
    assert torch.equal(got, want)
    if name.startswith("every line unmatched"):
        assert (want == -1).all()  # each warp walked all 7000 rows of ACL 1
    got = match_hist.match_rows_and_hists(f[:6], f[6], rk, span, n_acls,
                                          force_global=force_global)
    torch.cuda.synchronize()
    want = match_hist.match_rows_and_hists_plain(f[:6], f[6], rk, span, n_acls)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_empty_and_all_invalid_batches(cuda):
    packed, tuples = _case(2, 8, 300)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)
    empty = [x[:0] for x in f]
    assert first_match.first_match_rows(empty[:6], r.rules_k, r.acl_span).numel() == 0
    row, hr, hd = match_hist.match_rows_and_hists(f[:6], torch.zeros_like(f[6]), r.rules_k,
                                                 r.acl_span, 2)
    torch.cuda.synchronize()
    assert int(hr.sum()) == 0 and int(hd.sum()) == 0


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_step_on_the_card_equals_the_cpu_step(cuda, impl):
    packed, tuples = _case(3, 18, 1536, seed=4)
    tuples[::9, 6] = 0
    wire = pack.compact_batch(np.ascontiguousarray(tuples.T))
    cfg = AnalysisConfig(batch_size=1536, sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6))
    outs = []
    for dev in (torch.device("cpu"), cuda):
        rules = pipeline.ship_ruleset(packed, dev)
        state = pipeline.init_state(packed.n_keys, cfg, dev)
        for salt in range(3):
            state, out = pipeline.analysis_step(
                state, rules, torch.from_numpy(wire.view(np.int32)).to(dev),
                n_keys=packed.n_keys, topk_k=64, salt=salt, match_impl=impl,
            )
        outs.append((pipeline.state_to_numpy(state), [x.cpu() for x in out]))
    (cs, co), (gs, go) = outs
    for k in cs:
        np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
    for a, b in zip(co, go):
        assert torch.equal(a, b)


def test_wrapper_refuses_mixed_devices(cuda):
    packed, tuples = _case(2, 8, 64)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, torch.device("cpu"))[:6]
    with pytest.raises(ValueError, match="device"):
        first_match.first_match_rows(f, r.rules_k, r.acl_span)


@pytest.mark.parametrize("weighted", [False, True])
def test_prefetch_with_pinned_ring_equals_synchronous_run(cuda, tmp_path, weighted):
    """Depth 2 (pinned ring, side-stream copies, event waits) gives the
    registers of depth 0, bit for bit, over a wire input of 16 chunks."""
    from ruleset_analysis_tpu_torch.hostside import wire
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_wire

    packed, _ = _case(16, 256, 1)
    tuples = synth.synth_flow_tuples(packed, 1 << 18, 5000, seed=7)
    path = str(tmp_path / "in.rawire")
    batch = 1 << 14
    with wire.WireWriter(path, wire.ruleset_fingerprint(packed), batch,
                         weighted=weighted) as w:
        for i in range(0, tuples.shape[0], batch):
            rows = pack.compact_batch(np.ascontiguousarray(tuples[i:i + batch].T))
            w.add(pack.coalesce_wire(rows) if weighted else rows, batch, 0)
    # coalesced blocks hold fewer rows: a narrower run batch keeps >= 8 chunks
    impl, run_batch = ("scan", batch // 8) if weighted else ("fused", batch)
    runs = {}
    for depth in (0, 2):
        cfg = AnalysisConfig(batch_size=run_batch, prefetch_depth=depth, match_impl=impl)
        runs[depth] = run_stream_wire(packed, path, cfg, return_state=True)
    (rep0, regs0), (rep2, regs2) = runs[0], runs[2]
    assert rep2.totals["chunks"] >= 8 and rep2.totals["backend"] == "torch-cuda"
    assert rep2.totals["ingest"]["pinned_buffers"] >= 1
    for k, v in regs0.items():
        assert (regs2[k] == v).all(), k
    assert rep2.per_rule == rep0.per_rule and rep2.talkers == rep0.talkers
    assert sum(e["hits"] for e in rep2.per_rule) == tuples.shape[0]


def test_ring_views_through_the_pinned_ring_equal_the_assembled_batch(cuda):
    """H2DRing.put_views bit-packs each view straight into its columns of the
    pinned buffer: the card gets the assembled batch's wire layout."""
    from ruleset_analysis_tpu_torch.runtime.ingest import H2DRing, to_device

    packed, tuples = _case(3, 24, 3 * 1000)
    views = [np.ascontiguousarray(tuples[i:i + 1000].T) for i in range(0, 3000, 1000)]
    ring = H2DRing(cuda, 3)
    for _ in range(4):  # reuse of each pinned buffer after its copy left it
        got = ring.put_views(views).use()
        want = to_device(pack.compact_batch(np.concatenate(views, axis=1)), cuda).use()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert ring.allocs == 3 and ring.bytes == 4 * 4 * 3000 * 4


@pytest.mark.parametrize("mode", ["process", "thread", "ring"])
def test_feeder_run_on_the_card_equals_the_cpu_run(cuda, tmp_path, mode):
    """A feeder run on the card (ring views through the pinned ring) gives
    the registers and Report of the same run on the CPU."""
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    text = synth.synth_config(n_acls=4, rules_per_acl=32, seed=3, egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 20000, seed=4), seed=5)
    path = tmp_path / "a.log"
    path.write_text("\n".join(lines) + "\n")
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = AnalysisConfig(batch_size=2048, device=device)
        runs[device] = run_stream_file(packed, str(path), cfg, return_state=True,
                                       feed_workers=3, feed_mode=mode)
    (rep, regs), (crep, cregs) = runs["cuda"], runs["cpu"]
    assert rep.totals["backend"] == "torch-cuda" and rep.totals["chunks"] >= 8
    for k, v in cregs.items():
        assert (regs[k] == v).all(), k
    assert rep.per_rule == crep.per_rule and rep.talkers == crep.talkers


@pytest.mark.parametrize("depth", [0, 2])
def test_stacked_run_on_the_card_equals_the_cpu_run(cuda, tmp_path, depth):
    """``--layout stacked`` on the card: each grouped chunk (G x lane lines,
    here not the batch width) crosses by the pinned ring (prefetch) or a
    plain copy and launches first_match once; registers and Report equal
    the same run on the CPU."""
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    text = synth.synth_config(n_acls=4, rules_per_acl=32, seed=3, egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 20000, seed=4), seed=5)
    path = tmp_path / "a.log"
    path.write_text("\n".join(lines) + "\n")
    runs, launched = {}, {}
    for device in ("cuda", "cpu"):
        cfg = AnalysisConfig(batch_size=2048, device=device, layout="stacked", stacked_lane=700,
                             match_impl="scan", prefetch_depth=depth)
        before = first_match.first_match_rows.launches
        runs[device] = run_stream_file(packed, str(path), cfg, return_state=True)
        launched[device] = first_match.first_match_rows.launches - before
    (rep, regs), (crep, cregs) = runs["cuda"], runs["cpu"]
    assert rep.totals["backend"] == "torch-cuda" and rep.totals["chunks"] >= 8
    assert launched == {"cuda": rep.totals["chunks"], "cpu": 0}
    for k, v in cregs.items():
        assert (regs[k] == v).all(), k
    assert rep.per_rule == crep.per_rule and rep.talkers == crep.talkers
    if depth:
        assert rep.totals["ingest"]["pinned_buffers"] >= 1


def _case6(n_acls, rules_per_acl, n, seed=0):
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=seed,
                              v6_fraction=0.3)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    return packed, synth.synth_tuples6(packed, n, seed=seed + 1)


def _v6_layouts(tuples6, dev):
    """The three v6 batch layouts of the same lines, as int32 card tensors."""
    t = np.ascontiguousarray(tuples6.T)
    w = pack.compact_batch6(t)
    ww = np.concatenate([w, t[pack.T6_VALID:pack.T6_VALID + 1]])
    return {name: torch.from_numpy(np.ascontiguousarray(b).view(np.int32)).to(dev)
            for name, b in (("tuple", t), ("wire", w), ("weighted wire", ww))}


def _fields6(batch):
    from ruleset_analysis_tpu_torch.ops.match6 import FIELDS6

    cols, _ = pipeline.batch_cols6(batch)
    return [cols[k] for k in FIELDS6]


@pytest.mark.parametrize("n_acls,rules,n", [(3, 24, 2048), (16, 256, 4099)])
def test_first_match6_kernel_equals_plain(cuda, n_acls, rules, n):
    from ruleset_analysis_tpu_torch.ops import first_match6

    packed, t6 = _case6(n_acls, rules, n)
    r6 = pipeline.ship_ruleset6(packed, cuda)
    for name, batch in _v6_layouts(t6, cuda).items():
        f = _fields6(batch)
        before = first_match6.first_match_rows6.launches
        got = first_match6.first_match_rows6(f, r6.rules_k6, r6.acl_span6)
        torch.cuda.synchronize()
        assert first_match6.first_match_rows6.launches == before + 1
        want = first_match6.first_match_rows6_plain(f, r6.rules_k6, r6.acl_span6)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("name", list(synth.match6_edge_cases(n=1)))
def test_first_match6_kernel_equals_plain_on_edge_cases(cuda, name):
    from ruleset_analysis_tpu_torch.ops import first_match6

    rules6, t6 = synth.match6_edge_cases(n=4099, seed=3)[name]
    padded = torch.from_numpy(pipeline.pad_rules6(rules6).astype(np.int64))
    rk = first_match6.prep_rules6(padded).to(cuda)
    span = first_match.acl_spans(rk)
    b = torch.from_numpy(np.ascontiguousarray(t6.T).view(np.int32)).to(cuda)
    f = _fields6(b)
    got = first_match6.first_match_rows6(f, rk, span)
    torch.cuda.synchronize()
    assert torch.equal(got, first_match6.first_match_rows6_plain(f, rk, span))


@pytest.mark.parametrize("layout", ["tuple", "wire", "weighted wire"])
def test_step6_on_the_card_equals_the_cpu_step(cuda, layout):
    packed, t6 = _case6(3, 18, 1536, seed=4)
    t6[::9, pack.T6_VALID] = 0
    cfg = AnalysisConfig(batch_size=1536, sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6))
    outs = []
    for dev in (torch.device("cpu"), cuda):
        rules6 = pipeline.ship_ruleset6(packed, dev)
        state = pipeline.init_state(packed.n_keys, cfg, dev)
        batch = _v6_layouts(t6, dev)[layout]
        for salt in range(3):
            state, out = pipeline.analysis_step6(state, rules6, batch, n_keys=packed.n_keys,
                                                 topk_k=64, salt=salt)
        outs.append((pipeline.state_to_numpy(state), [x.cpu() for x in out]))
    (cs, co), (gs, go) = outs
    for k in cs:
        np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
    for a, b in zip(co, go):
        assert torch.equal(a, b)


def test_dual_stack_text_run_launches_the_v6_kernel_per_v6_chunk(cuda, tmp_path):
    """A dual-stack text run on the card: prefetch 2 equals prefetch 0, bit
    for bit, and every v6 chunk went through the first_match6 kernel."""
    from ruleset_analysis_tpu_torch.ops import first_match6
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    packed, _ = _case6(4, 32, 1)
    log = str(tmp_path / "fw1.log")
    synth.synth_syslog_file(packed, log, 1 << 15, seed=5, v6_fraction=0.3)
    runs = {}
    for depth in (0, 2):
        first_match6.first_match_rows6.launches = 0
        first_match.first_match_rows.launches = 0
        cfg = AnalysisConfig(batch_size=4096, prefetch_depth=depth)
        rep, regs = run_stream_file(packed, [log], cfg, native=True, return_state=True)
        n6 = first_match6.first_match_rows6.launches
        # the v4 chunks ran the default scan route's first_match kernel
        assert n6 > 0 and n6 + first_match.first_match_rows.launches == rep.totals["chunks"]
        runs[depth] = (rep, regs)
    (rep0, regs0), (rep2, regs2) = runs[0], runs[2]
    for k, v in regs0.items():
        assert (regs2[k] == v).all(), k
    assert rep2.per_rule == rep0.per_rule and rep2.talkers == rep0.talkers


# --- the register tail (csrc/reg_tail.cu) ------------------------------------

REG_TAIL_CASES = list(synth.reg_tail_cases(1, 2))


def _tail_run(case, dev, n_keys, width=1 << 12, p=8, force_global=False):
    from ruleset_analysis_tpu_torch.ops import reg_tail

    rng = np.random.default_rng(9)
    talk = torch.from_numpy(rng.integers(0, 1 << 32, (2, width), dtype=np.uint64)
                            .astype(np.int64)).to(dev)
    hll = torch.from_numpy(rng.integers(0, 5, (n_keys, 1 << p)).astype(np.int64)).to(dev)
    row, valid, acl, key_k = (torch.from_numpy(case[k]).to(dev)
                              for k in ("row", "valid", "acl", "key_k"))
    src = tuple(torch.from_numpy(x).to(dev) for x in case["src"])
    kw = {k: case[k] for k in ("counts", "select", "sample_shift", "salt", "acl_tag", "n_rows")}
    if dev.type == "cuda":
        kw["force_global"] = force_global
    delta, cnt, rep = reg_tail.reg_tail(talk, hll, row, valid, acl, src, key_k, **kw)
    out = [talk, hll, delta, cnt, rep]
    if kw["select"]:
        b = row.shape[0]
        k = min(64, b if not kw["sample_shift"] or b < 8 else b >> kw["sample_shift"])
        out += reg_tail.select_tables(cnt, rep, acl, src, talk, k, acl_tag=kw["acl_tag"],
                                      salt=kw["salt"], sample_shift=kw["sample_shift"])
    return [None if x is None else x.cpu() for x in out]


@pytest.mark.parametrize("force_global", [False, True], ids=["shared counts", "global counts"])
@pytest.mark.parametrize("name", REG_TAIL_CASES)
def test_reg_tail_kernel_equals_plain(cuda, name, force_global):
    """Registers, counts delta, candidate table and picked candidates of the
    kernels equal the plain version's on the same inputs (tolerance 0), with
    the counts delta in the block histograms and with global atomics."""
    from ruleset_analysis_tpu_torch.ops import reg_tail

    n_keys = 300
    case = synth.reg_tail_cases(20011, n_keys, seed=3)[name]
    before = reg_tail.reg_tail.launches
    got = _tail_run(case, cuda, n_keys, force_global=force_global)
    torch.cuda.synchronize()
    assert reg_tail.reg_tail.launches == before + 1
    want = _tail_run(case, torch.device("cpu"), n_keys)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_reg_tail_counts_past_shared_memory_take_global_atomics(cuda):
    """A key space too large for one block's histogram runs the global mode
    and gives the plain version's delta."""
    from ruleset_analysis_tpu_torch.ops import reg_tail

    n_keys = reg_tail.smem_limit(torch.cuda.current_device()) // 4 + 1
    assert reg_tail.uses_global_counts(n_keys, torch.cuda.current_device())
    case = synth.reg_tail_cases(50021, n_keys, seed=5)["scan route (delta in the kernel), selecting"]
    got = _tail_run(case, cuda, n_keys, p=4)
    want = _tail_run(case, torch.device("cpu"), n_keys, p=4)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


SELECT_CASES = list(synth.select_cases(2, 2))


@pytest.mark.parametrize("k", [1, 63, 64, 2049, "slots"])
@pytest.mark.parametrize("name", SELECT_CASES)
def test_select_kernel_equals_plain(cuda, name, k):
    """The select kernel's candidates equal select_tables_plain's (tolerance
    0) over every select table, k from 1 to the whole table (above the
    in-block ranking's cap it launches twice)."""
    from ruleset_analysis_tpu_torch.ops import reg_tail, topk

    slots, n = topk.CAND_SLOTS, 1 << 16
    case = synth.select_cases(slots, n, seed=7)[name]
    k = slots if k == "slots" else k
    rng = np.random.default_rng(3)
    acl = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    src = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)),)
    talk = torch.from_numpy(rng.integers(0, 1 << 20, (2, 1 << 14)).astype(np.int64))
    args = [torch.from_numpy(case["cnt"]), torch.from_numpy(case["rep"]), acl, src, talk]
    want = reg_tail.select_tables(*args, k, salt=5)
    dev_args = [x.to(cuda) for x in args[:3]] + [tuple(x.to(cuda) for x in src), talk.to(cuda)]
    before = reg_tail.select_tables.launches
    got = reg_tail.select_tables(*dev_args, k, salt=5)
    torch.cuda.synchronize()
    assert reg_tail.select_tables.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_select_launches_only_its_own_kernels(cuda):
    """On the card select_tables runs the select kernel and nothing else: no
    torch.topk, sort or elementwise op of the library."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ruleset_analysis_tpu_torch.ops import reg_tail, topk

    case = synth.select_cases(topk.CAND_SLOTS, 4096, seed=1)["ties at small counts"]
    cnt, rep = (torch.from_numpy(case[k]).to(cuda) for k in ("cnt", "rep"))
    acl = torch.zeros(4096, dtype=torch.int32, device=cuda)
    talk = torch.zeros((2, 1 << 14), dtype=torch.int64, device=cuda)
    reg_tail.select_tables(cnt, rep, acl, (acl,), talk, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reg_tail.select_tables(cnt, rep, acl, (acl,), talk, 64)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    assert names and all("select_kernel" in n for n in names), names


#: (topk_every, topk_sample_shift)
STEP_PATHS = [(1, 0), (2, 3), (3, 2)]


@pytest.mark.parametrize("v6", [False, True])
@pytest.mark.parametrize("every,shift", STEP_PATHS)
def test_step_update_paths_on_the_card_equal_the_cpu_step(cuda, every, shift, v6):
    """The step on the card equals the CPU step, deferred selection and
    sampling included, and launches reg_tail once a step."""
    from ruleset_analysis_tpu_torch.ops import reg_tail

    if v6:
        packed, t = _case6(3, 18, 1536, seed=5)
        t[::9, pack.T6_VALID] = 0
    else:
        packed, t = _case(3, 18, 1536, seed=5)
        t[::9, 6] = 0
    cfg = AnalysisConfig(batch_size=1536,
                         sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6))
    kw = dict(n_keys=packed.n_keys, topk_k=64, topk_every=every, topk_sample_shift=shift)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        state = pipeline.init_state(packed.n_keys, cfg, dev)
        if v6:
            rules = pipeline.ship_ruleset6(packed, dev)
            batch = _v6_layouts(t, dev)["wire"]
        else:
            rules = pipeline.ship_ruleset(packed, dev)
            batch = torch.from_numpy(
                pack.compact_batch(np.ascontiguousarray(t.T)).view(np.int32)).to(dev)
        before = reg_tail.reg_tail.launches
        for salt in range(3):
            if v6:
                state, out = pipeline.analysis_step6(state, rules, batch, salt=salt, **kw)
            else:
                state, out = pipeline.analysis_step(state, rules, batch, salt=salt,
                                                    match_impl="scan", **kw)
        if dev.type == "cuda":
            assert reg_tail.reg_tail.launches - before == 3
        outs.append((pipeline.state_to_numpy(state), [x.cpu() for x in out]))
    (cs, co), (gs, go) = outs
    for k in cs:
        np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
    for a, b in zip(co, go):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["scan", "fused", "v6", "stacked"])
def test_virtual_shards_on_the_card_equal_one_shard_and_the_cpu(cuda, kind, n):
    """A mesh of n virtual shards on one card: the registers of the one-shard
    mesh, and the candidates of the same mesh's plain versions on the CPU
    (``[cpu] * n``, the same batches), chunk by chunk, a deferred chunk
    among them; every chunk launches reg_tail once a shard."""
    from ruleset_analysis_tpu_torch.ops import reg_tail
    from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib
    from ruleset_analysis_tpu_torch.parallel import step as step_lib

    if kind == "v6":
        packed, t = _case6(3, 18, 2048, seed=7)
        batches = [np.ascontiguousarray(t.T)] * 3
    else:
        packed, t = _case(3, 18, 4096, seed=7)
        if kind == "stacked":
            g = pack.GroupBuffer(packed.n_acls, 512).add(t)[0]
            batches = [g] * 3
        else:
            batches = [np.ascontiguousarray(t[i * 1024:(i + 1) * 1024].T) for i in range(3)]
    cfg = AnalysisConfig(batch_size=1024, match_impl="fused" if kind == "fused" else "scan",
                         sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6,
                                             topk_every=2))
    runs = []
    for devs in ([cuda], [cuda] * n, [torch.device("cpu")] * n):
        mesh = mesh_lib.make_mesh(devs)
        state = step_lib.init_state(packed.n_keys, cfg, mesh)
        if kind == "v6":
            step, rules = (step_lib.make_parallel_step6(mesh, cfg, packed.n_keys),
                           step_lib.ship6(packed, mesh))
        else:
            step, rules = (step_lib.make_parallel_step(mesh, cfg, packed.n_keys),
                           step_lib.ship(packed, mesh))
        outs = []
        before = reg_tail.reg_tail.launches
        for salt, b in enumerate(batches):
            shards = (mesh_lib.shard_grouped(mesh, b, False) if kind == "stacked"
                      else mesh_lib.shard_batch(mesh, b))
            state, out = step(state, rules, [s.use() for s in shards], salt)
            outs.append([x.cpu() for x in out])
        if devs[0].type == "cuda":
            assert reg_tail.reg_tail.launches - before == 3 * len(devs)
        runs.append((pipeline.state_to_numpy(state[0]), outs))
    (one, _), (card, card_out), (cpu, cpu_out) = runs
    for k in one:
        np.testing.assert_array_equal(card[k], one[k], err_msg=k)
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    for a, b in zip(card_out, cpu_out):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
