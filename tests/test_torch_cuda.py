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


@pytest.fixture(scope="module")
def rules2048():
    """One ACL of 2048 rules (3335 rows), the largest flat point of the
    reference's rule-scale sweep."""
    text = synth.synth_config(n_acls=1, rules_per_acl=2048, seed=2048)
    return pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")]).rules


def test_relation_tile_kernel_equals_plain_on_edge_tiles(cuda, rules2048):
    """Bit for bit: T = 512 blocks, a ragged 513-row tile, the grid's last
    row block, 1 x 1, an all-padding block, cross-ACL blocks, u32 edges;
    one relation_grid launch a tile, its words equal to the plain version's."""
    from ruleset_analysis_tpu_torch.ops import overlap

    for name, (ri, rj) in synth.relation_edge_cases(rules2048).items():
        a, b = (torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(cuda)
                for x in (ri, rj))
        before = overlap.relation_grid.launches
        got = overlap.relation_tile(a, b)
        torch.cuda.synchronize()
        assert overlap.relation_grid.launches == before + 1, name
        want = overlap.relation_tile_plain(a.cpu(), b.cpu())
        for g, w in zip(got, want):
            assert g.dtype == torch.bool and torch.equal(g.cpu(), w), name
        t = max(ri.shape[0], rj.shape[0])
        blocks = np.concatenate([overlap._pad_rows(ri, t), overlap._pad_rows(rj, t)])
        blocks = torch.from_numpy(blocks.view(np.int32)).to(cuda)
        work = torch.tensor([[0, 1], [1, 0], [1, 1]], dtype=torch.int32)
        want = overlap.relation_grid_plain(blocks.cpu(), work, t)
        got = overlap.relation_grid(blocks, work, t)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("n_acls,rules,tile,lower_only", [
    (1, 2048, 512, True), (16, 256, 512, True), (3, 24, 16, False), (4, 64, 33, True),
    (2, 40, 1, True), (1, 300, 600, False),
])
def test_relation_grid_kernel_equals_plain_on_work_lists(cuda, n_acls, rules, tile, lower_only):
    """A whole analysis's work list (every ACL's tiles) in one launch,
    bit-identical to the plain version."""
    from ruleset_analysis_tpu_torch.ops import overlap

    seed = 2048 if rules == 2048 else 0
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules, seed=seed)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    acl = packed.rules[:, pack.R_ACL]
    slabs = [packed.rules[acl == g] for g in range(packed.n_acls)]
    _, [(index, work)] = overlap.grid_work([s.shape[0] for s in slabs], tile,
                                           lower_only=lower_only)
    blocks = np.concatenate([overlap._pad_rows(slabs[s][b0:b0 + tile], tile)
                             for s, b0 in index])
    blocks = torch.from_numpy(blocks.view(np.int32)).to(cuda)
    work = torch.from_numpy(work)
    want = overlap.relation_grid_plain(blocks, work, tile)
    before = overlap.relation_grid.tiles
    got = overlap.relation_grid(blocks, work, tile)
    torch.cuda.synchronize()
    assert overlap.relation_grid.tiles == before + work.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pair_relations_peak_memory_is_one_slab_and_a_chunk(cuda, rules2048):
    """The 2048-rule ACL's 49 full tiles: the card's peak over the call and
    the unpack is the slab's [2, R, R] bools, the words, the blocks and one
    chunk of UNPACK_TILES tiles, not 49 tiles' temporaries; and the result
    is the CPU's."""
    from ruleset_analysis_tpu_torch.ops import overlap

    r, tile = rules2048.shape[0], 512
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = overlap.pair_relations(rules2048, tile=tile, devices=[cuda])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    n_tiles = (-(-r // tile)) ** 2
    words = 2 * n_tiles * tile * tile // 8
    pairs = overlap.UNPACK_TILES * 2 * tile * tile
    chunk = pairs + pairs // 2 + pairs // 4  # the bools, the byte index, the words twice
    allowed = 2 * r * r + words + chunk + (-(-r // tile)) * tile * 48 + (4 << 20)
    assert peak <= allowed < n_tiles * 2 * tile * tile * 4, (peak, allowed)
    want = overlap.pair_relations(rules2048, tile=tile)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n_acls,rules,v6", [(3, 24, 0.0), (2, 64, 0.3), (16, 256, 0.0),
                                             (1, 2048, 0.0)])
def test_analyze_on_the_card_equals_the_cpu(cuda, n_acls, rules, v6):
    """`analyze_ruleset` on the card: the CPU's verdicts, one relation_grid
    launch over all its tiles, and the witness pass through the first_match
    kernel."""
    from ruleset_analysis_tpu_torch.ops import overlap
    from ruleset_analysis_tpu_torch.runtime import staticanalysis

    seed = 2048 if rules == 2048 else 0
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules, seed=seed, v6_fraction=v6)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    grid = overlap.relation_grid
    rt, tiles, fm = grid.launches, grid.tiles, first_match.first_match_rows.launches
    on_card = staticanalysis.analyze_ruleset(packed, device="cuda")
    rt, tiles = grid.launches - rt, grid.tiles - tiles
    fm = first_match.first_match_rows.launches - fm
    on_cpu = staticanalysis.analyze_ruleset(packed, device="cpu")
    a, b = on_card.to_obj(packed), on_cpu.to_obj(packed)
    a["meta"].pop("duration_sec")
    b["meta"].pop("duration_sec")
    assert a == b
    assert rt == 1 and tiles == a["meta"]["tiles_run"] > 0
    assert (fm > 0) == (a["meta"]["witnesses_checked"] > 0)


@pytest.mark.parametrize("views", [False, True])
def test_recovered_device_put_through_the_pinned_ring_keeps_every_batch(cuda, views):
    """``stream.device_put.fail@2:k`` with k the ring's depth plus one: the
    site fires before a buffer is claimed, so the failed attempts claim
    nothing, and every batch reaches the card intact and in order."""
    from ruleset_analysis_tpu_torch.hostside.feeder import _RingBatch
    from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib
    from ruleset_analysis_tpu_torch.runtime import faults, ingest, retrypolicy

    depth = 4
    mesh = mesh_lib.make_mesh([cuda])
    rings = mesh_lib.make_rings(mesh, depth)
    ring = rings[mesh.devices[0]]
    packed, tuples = _case(3, 24, 8 * 512)
    batches = [np.ascontiguousarray(tuples[i:i + 512].T) for i in range(0, 8 * 512, 512)]
    retrypolicy.configure(f"device_put={depth + 3}/0.001")
    released = []
    got = []
    try:
        with faults.armed(faults.FaultPlan.parse(f"stream.device_put.fail@2:{depth + 1}")):
            for i, b in enumerate(batches):
                if views:
                    rb = _RingBatch([b], 512, lambda i=i: released.append(i))
                    got.append(ingest.views_to_device(rb, mesh.devices[0], ring).use())
                else:
                    (db,) = mesh_lib.shard_batch(mesh, pack.compact_batch(b), rings)
                    got.append(db.use())
        torch.cuda.synchronize()
        for g, b in zip(got, batches):
            want = torch.from_numpy(pack.compact_batch(b).view(np.int32)).to(cuda)
            assert torch.equal(g, want)
        assert retrypolicy.counters()["device_put"] == {
            "attempts": depth + 1, "recoveries": 1, "giveups": 0}
        # one claim a batch: the ring went round exactly once per batch
        assert ring._next == len(batches) % depth and ring.allocs == depth
        assert released == (list(range(len(batches))) if views else [])
    finally:
        retrypolicy.configure("")


def test_a_cuda_error_at_the_copy_is_not_retried(cuda, monkeypatch):
    """A CUDA error poisons the context: the copy seam escalates it at once,
    with no retry on the dead context (the error is simulated at the send,
    so the card stays healthy for the other tests)."""
    from ruleset_analysis_tpu_torch import errors
    from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib
    from ruleset_analysis_tpu_torch.runtime import ingest, retrypolicy

    calls = []

    def dead_context(self, i, buf):
        calls.append(i)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ingest.H2DRing, "_send", dead_context)
    mesh = mesh_lib.make_mesh([cuda])
    rings = mesh_lib.make_rings(mesh, 4)
    packed, tuples = _case(3, 24, 512)
    retrypolicy.configure("")
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert not errors.is_transient(err)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        mesh_lib.shard_batch(mesh, pack.compact_batch(np.ascontiguousarray(tuples.T)), rings)
    assert len(calls) == 1
    assert retrypolicy.counters()["device_put"] == {"attempts": 0, "recoveries": 0,
                                                    "giveups": 1}
    assert errors.exit_code_for(err) == errors.EXIT_ANALYSIS


def test_device_memory_gauges_read_the_named_card_from_any_thread(cuda):
    """The metrics plane's device_mem sampler: integers within the card's
    memory, the same from a second thread (the ra-metrics thread's case,
    whose current device is not the run's)."""
    import threading

    from ruleset_analysis_tpu_torch.runtime import devprof

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    g = devprof.device_memory_gauges(dev)
    assert all(type(v) is int for v in g.values()), g
    total = torch.cuda.get_device_properties(dev).total_memory
    assert (0 < g["device_mem_bytes_in_use"] <= g["device_mem_peak_bytes_in_use"]
            <= g["device_mem_bytes_limit"] == total), g
    assert g["device_mem_bytes_in_use"] >= x.numel() * 4
    seen = {}
    t = threading.Thread(target=lambda: seen.update(devprof.device_memory_gauges(dev)))
    t.start()
    t.join()
    assert seen == g
    with pytest.raises(ValueError, match="indexed"):
        devprof.device_memory_gauges("cuda")
    del x


def test_profiler_trace_names_the_first_match_kernel(cuda, tmp_path):
    """metrics.Profiler on a CUDA run: the trace names the hand kernel under
    its __global__ name, and never holds more of its records than it had
    launches.  Late in a long process torch.profiler on this card drops
    whole calls' records (PERF.md section 7: 1 of 3 here in a whole run of
    this file, 3 of 3 alone), so a shortfall is reported as a warning with
    its counts; chip_smoke.py counts a whole run's records the same way."""
    import json
    import re
    import warnings

    from ruleset_analysis_tpu_torch.runtime import metrics

    packed, tuples = _case(4, 64, 4096)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)[:6]
    first_match.first_match_rows(f, r.rules_k, r.acl_span)
    torch.cuda.synchronize()
    launches = 3
    before = first_match.first_match_rows.launches
    p = metrics.Profiler(str(tmp_path), device="cuda")
    with p:
        for _ in range(launches):
            first_match.first_match_rows(f, r.rules_k, r.acl_span)
        torch.cuda.synchronize()
    assert first_match.first_match_rows.launches == before + launches
    with open(p.path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    # CUPTI's demangled name, in the .cu's anonymous namespace:
    # "(anonymous namespace)::first_match_kernel(unsigned int const*, ...)"
    kernels = [n for n in names if re.search(r"(^|[\s:])first_match_kernel\(", n)]
    assert 1 <= len(kernels) <= launches, sorted(set(names))
    if len(kernels) < launches:
        warnings.warn(f"torch.profiler kept {len(kernels)} of {launches} first_match_kernel "
                      "records")


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_devprof_capture_attributes_every_step_kernel_to_its_stage(cuda, tmp_path, impl):
    """An armed flat run on the card (`--devprof-out` through the API): every
    hand kernel record of the window lies in its KERNEL_STAGES primary
    stage, kernel_records names each step kernel, and the report equals the
    disarmed run's.  A record the profiler dropped shows as records_short
    (PERF.md section 7), reported as a warning with its counts."""
    import json
    import warnings

    from ruleset_analysis_tpu_torch.runtime import devprof
    from ruleset_analysis_tpu_torch.runtime.report import VOLATILE_TOTALS
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file
    from ruleset_analysis_tpu_torch.stages import KERNEL_STAGES

    packed, tuples = _case(3, 24, 8192)
    log = str(tmp_path / "c.log")
    with open(log, "w", encoding="utf-8") as fh:
        fh.write("\n".join(synth.render_syslog(packed, tuples, seed=2)) + "\n")
    cfg = AnalysisConfig(batch_size=1024, match_impl=impl)

    def image(rep):
        j = json.loads(rep.to_json())
        for k in VOLATILE_TOTALS:
            j["totals"].pop(k, None)
        return j

    plain = run_stream_file(packed, [log], cfg, native=False)
    devprof.arm(str(tmp_path / "dp"), steps=4, warmup=1)
    try:
        armed = run_stream_file(packed, [log], cfg, native=False)
    finally:
        devprof.shutdown()
    assert image(armed) == image(plain)
    dp = armed.totals["devprof"]
    assert dp["backend"] == "cuda" and dp["steps_profiled"] == 4
    assert dp["attributed_frac"] >= 0.9
    match = "match_hist_kernel" if impl == "fused" else "first_match_kernel"
    kr = dp["kernel_records"]
    assert kr[match]["launches"] == 4 and kr["reg_tail_kernel"]["launches"] == 4
    assert kr["select_kernel"]["launches"] >= 1
    with open(dp["trace_path"], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    recs = [r for r in devprof.attribute_events(events, programs={"step.flat"})
            if r["kernel"] is not None]
    assert recs and {r["kernel"] for r in recs} <= {match, "reg_tail_kernel", "select_kernel"}
    for r in recs:
        assert r["program"] == "step.flat"
        assert r["stage"] == KERNEL_STAGES[r["kernel"]][0], r
    fused = [f["name"] for f in dp["programs"]["step.flat"]["fusions"]]
    assert "reg_tail_kernel" in fused
    if dp["records_short"]:
        warnings.warn(f"torch.profiler kept fewer records than launches: {kr}")
