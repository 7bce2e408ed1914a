"""The stacked layout of the port (``run --layout stacked``) against the reference's.

Mirrors tests/test_stacked.py.  The port buckets lines by ACL with its
copy of the reference's ``GroupBuffer`` and steps each grouped batch as
the flat batch of its lines in group-major order (``flatten_grouped``)
on the scan route, where the reference steps per-ACL rule slabs.  So:

- ``GroupBuffer`` emits the reference's grouped batches byte for byte
  over random add/flush sequences (skewed ACL mixes, odd sizes, lane 1,
  weights, acl ids past the last group, which both drop);
- ``compact_batch(_w)`` of a flattened grouped batch is the reference's
  ``compact_grouped(_w)``, and the port's flat step over it gives the
  registers and candidates of the reference's ``analysis_step_stacked``;
- a stacked run's Report equals the reference's stacked run's (talkers
  included) over Python and native text with and without prefetch, a
  lane override and ``--update-impl sorted``; its registers equal the
  flat run's;
- stacked snapshots resume across the packages, and never across layouts;
- the refusals are the reference's (``fused``, a negative lane, the
  oracle backend).

The other input paths have their stacked cases beside their flat ones
(``test_torch_{wire,coalesce,stream6,wire6,feeder,checkpoint}.py``).  The
reference runs on a one-device mesh; tolerance 0 throughout.  The
multi-device stacked step (``make_parallel_step_stacked``) waits for the
multi-GPU item of ROADMAP Queue A.
"""

import dataclasses
import functools
import json
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as jpipe  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import CheckpointMismatch  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, oracle, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import T_ACL, T_SRC, T_VALID, TUPLE_COLS  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream, run_stream_file  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKETCH = dict(cms_width=1 << 10, cms_depth=4, hll_p=6)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")


def mesh1():
    return rmesh.make_mesh(jax.devices()[:1])


def _cfg(**kw):
    kw.setdefault("match_impl", "scan")
    kw.setdefault("layout", "stacked")
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu", **kw)


def _jcfg(**kw):
    kw.setdefault("layout", "stacked")
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH), **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def multi_fw(tmp_path_factory):
    """The reference test's three firewalls (2 ACLs x 12 rules each) in one
    key universe, and 3000 lines over them: junk lines, and a run of 600
    junk lines (a Python batch with no tuple row, a native all-invalid one),
    and the oracle's result over them."""
    d = tmp_path_factory.mktemp("stacked")
    rulesets = [aclparse.parse_asa_config(
        synth.synth_config(n_acls=2, rules_per_acl=12, seed=s), f"fw{s}") for s in range(3)]
    packed = pack.pack_rulesets(rulesets)
    pack.save_packed(packed, str(d / "fw"))
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 3000, seed=5), seed=6,
                                variety=0.3)
    lines[::89] = ["not an ASA line"] * len(lines[::89])
    lines[1400:1400] = [f"junk {i}" for i in range(600)]
    log = d / "fw.log"
    log.write_text("\n".join(lines) + "\n")
    res = oracle.Oracle(rulesets).consume(list(lines))
    return packed, rpack.load_packed(str(d / "fw")), res, lines, str(log), d


# --- GroupBuffer (tests/test_stacked.py TestGrouping and the property) ------


def _random_rows(rng, r, n_groups, b, weights=False, stray=False):
    batch = rng.integers(0, 1 << 32, size=(b, TUPLE_COLS), dtype=np.uint32)
    mix = r.random()
    if mix < 0.3:  # skewed: all one group
        acls = np.full(b, r.randrange(n_groups), dtype=np.uint32)
    else:
        acls = rng.integers(0, n_groups, size=b).astype(np.uint32)
    if stray:  # acl ids past the last group: both buffers drop them
        acls[rng.random(b) < 0.2] = n_groups + rng.integers(0, 3)
    batch[:, T_ACL] = acls
    valid = (rng.random(b) < 0.8).astype(np.uint32)
    if weights:
        valid *= rng.integers(1, 1 << 20, size=b, dtype=np.uint32)
    batch[:, T_VALID] = valid
    return batch


@pytest.mark.parametrize("trial", range(8))
def test_group_buffer_emits_the_references_batches(trial):
    r = random.Random(trial)
    rng = np.random.default_rng(trial)
    n_groups = r.randint(1, 6)
    lane = (1, 3, 8, 16)[trial % 4]
    mine, ref = pack.GroupBuffer(n_groups, lane), rpack.GroupBuffer(n_groups, lane)
    emitted = 0
    for _ in range(r.randint(4, 14)):
        if r.random() < 0.2:
            got, want = mine.flush(), ref.flush()
        else:
            batch = _random_rows(rng, r, n_groups, r.randint(1, 64),
                                 weights=trial % 2 == 1, stray=trial >= 4)
            got, want = mine.add(batch), ref.add(batch.copy())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint32 and g.shape == (n_groups, TUPLE_COLS, lane)
            np.testing.assert_array_equal(g, w)
        emitted += len(got)
    got, want = mine.flush(), ref.flush()
    assert len(got) == len(want) and emitted + len(got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert mine.flush() == []


def test_group_buffer_randomized_conservation():
    """Over random add/flush sequences every valid input line is emitted
    exactly once, in its own ACL's lane, in input order; invalid lines
    never appear, and padding is all zero."""
    rng = np.random.default_rng(77)
    for trial in range(25):
        r = random.Random(trial)
        n_groups = r.randint(1, 6)
        lane = r.choice([4, 8, 16, 32])
        buf = pack.GroupBuffer(n_groups, lane)
        sent = {g: [] for g in range(n_groups)}
        got = {g: [] for g in range(n_groups)}
        serial = 1  # src doubles as a unique line id (0 is padding)

        def consume(grouped_batches):
            for gb in grouped_batches:
                assert gb.shape == (n_groups, TUPLE_COLS, lane)
                for g in range(n_groups):
                    v = gb[g, T_VALID] == 1
                    assert (gb[g, T_ACL][v] == g).all()
                    got[g].extend(gb[g, T_SRC][v].tolist())
                    assert (gb[g][:, ~v] == 0).all()

        for _ in range(r.randint(1, 12)):
            b = r.randint(1, 64)
            batch = np.zeros((b, TUPLE_COLS), dtype=np.uint32)
            if r.random() < 0.3:
                acls = np.full(b, r.randrange(n_groups), dtype=np.uint32)
            else:
                acls = rng.integers(0, n_groups, size=b).astype(np.uint32)
            valid = (rng.random(b) < 0.8).astype(np.uint32)
            batch[:, T_ACL] = acls
            batch[:, T_VALID] = valid
            for i in range(b):
                if valid[i]:
                    batch[i, T_SRC] = serial
                    sent[int(acls[i])].append(serial)
                    serial += 1
            consume(buf.add(batch))
        consume(buf.flush())
        assert got == sent, f"trial {trial}: lines lost, duplicated or reordered"
        assert buf.flush() == []


def test_group_buffer_carries_overflow(multi_fw):
    packed = multi_fw[0]
    tuples = synth.synth_tuples(packed, 700, seed=2)
    buf = pack.GroupBuffer(packed.n_acls, lane=64)
    batches = []
    for i in range(0, 700, 100):
        batches += buf.add(tuples[i:i + 100])
    batches += buf.flush()
    assert sum(int(b[:, T_VALID, :].sum()) for b in batches) == int(tuples[:, T_VALID].sum())
    for b in batches:
        for gid in range(packed.n_acls):
            n = int(b[gid, T_VALID].sum())
            assert (b[gid, T_ACL, :n] == gid).all()


def test_rows_past_the_last_group_are_dropped_as_in_the_reference():
    """A valid row whose acl is >= n_groups never lands in a bucket (the
    reference's searchsorted places it past every group): reproduced."""
    batch = np.zeros((6, TUPLE_COLS), dtype=np.uint32)
    batch[:, T_ACL] = [0, 1, 2, 7, 1, 0]
    batch[:, T_VALID] = 1
    batch[:, T_SRC] = np.arange(1, 7)
    for mod in (pack, rpack):
        buf = mod.GroupBuffer(2, 4)
        assert buf.add(batch) == []
        (g,) = buf.flush()
        assert g[0, T_SRC].tolist() == [1, 6, 0, 0] and g[1, T_SRC].tolist() == [2, 5, 0, 0]


# --- the grouped batch on the flat step -------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_flattened_grouped_batch_packs_as_compact_grouped(weighted):
    rng = np.random.default_rng(3)
    g = rng.integers(0, 1 << 32, size=(5, TUPLE_COLS, 37), dtype=np.uint32)
    g[:, T_ACL] %= 5
    g[:, T_VALID] = rng.integers(0, 4, size=(5, 37)) if weighted else rng.integers(0, 2, (5, 37))
    flat = pack.flatten_grouped(g)
    assert flat.shape == (TUPLE_COLS, 5 * 37)
    mine = (pack.compact_batch_w if weighted else pack.compact_batch)(flat)
    ref = (rpack.compact_grouped_w if weighted else rpack.compact_grouped)(g)
    np.testing.assert_array_equal(mine, ref.transpose(1, 0, 2).reshape(ref.shape[1], -1))


@pytest.mark.parametrize("opts", [
    dict(),
    dict(weighted=True),
    dict(topk_sample_shift=2),
    dict(topk_every=2, lane=40),
])
def test_flat_step_over_flattened_grouped_batches_equals_the_stacked_step(multi_fw, opts):
    """Chunk by chunk (salt = chunk index): registers and candidates of the
    port's flat scan step over each flattened grouped batch equal the
    reference's ``analysis_step_stacked`` over the grouped wire batch,
    padding lanes (acl 0, valid 0) included."""
    packed, rpacked = multi_fw[:2]
    opts = dict(opts)
    weighted, lane = opts.pop("weighted", False), opts.pop("lane", 64)
    rng = np.random.default_rng(11)
    buf = pack.GroupBuffer(packed.n_acls, lane)
    grouped = []
    for c in range(5):
        t = synth.synth_tuples(packed, 400, seed=40 + c)
        t[rng.random(400) < 0.1, T_VALID] = 0
        if weighted:
            t[:, T_VALID] *= rng.integers(1, 1000, size=400, dtype=np.uint32)
        grouped += buf.add(t)
    grouped += buf.flush()
    assert len(grouped) >= 4
    k = SketchConfig().topk_chunk_candidates
    jstep = jax.jit(functools.partial(jpipe.analysis_step_stacked, n_keys=packed.n_keys,
                                      topk_k=k, **opts))
    jrules = jpipe.ship_ruleset_stacked(rpacked)
    jstate = jpipe.init_state(packed.n_keys, _jcfg())
    rules = pipeline.ship_ruleset(packed, "cpu")
    state = pipeline.init_state(packed.n_keys, _cfg(), "cpu")
    for c, g in enumerate(grouped):
        wire = (rpack.compact_grouped_w if weighted else rpack.compact_grouped)(g)
        jstate, jout = jstep(jstate, jrules, wire, salt=np.uint32(c))
        flat = (pack.compact_batch_w if weighted else pack.compact_batch)(pack.flatten_grouped(g))
        state, out = pipeline.analysis_step(
            state, rules, torch.from_numpy(flat.view(np.int32)), n_keys=packed.n_keys,
            topk_k=k, salt=c, match_impl="scan", **opts)
        want = jpipe.state_to_host(jstate)
        got = pipeline.state_to_numpy(state)
        for name in pipeline.AnalysisState._fields:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"chunk {c} {name}")
        for name, gv, wv in zip(pipeline.ChunkOut._fields, out, jout):
            np.testing.assert_array_equal(gv.numpy().astype(np.uint32), np.asarray(wv),
                                          err_msg=f"chunk {c} {name}")


# --- stacked runs against the reference --------------------------------------


#: case -> (port and reference config, native parse)
TEXT_CASES = {
    "python-prefetch0": (dict(prefetch_depth=0), False),
    "python-prefetch2": (dict(prefetch_depth=2), False),
    "native-prefetch0": (dict(prefetch_depth=0), True),
    "native-prefetch2": (dict(prefetch_depth=2), True),
    "lane64": (dict(stacked_lane=64), True),
    "sorted": (dict(update_impl="sorted", prefetch_depth=0), False),
}


@pytest.fixture(scope="module")
def flat_registers(multi_fw):
    packed, _, _, _, log, _ = multi_fw
    _, regs = run_stream_file(packed, [log], _cfg(layout="flat"), native=False, topk=TOPK,
                              return_state=True)
    return regs


@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_stacked_text_report_equals_the_reference(multi_fw, flat_registers, tmp_path, case):
    packed, rpacked, res, lines, log, _ = multi_fw
    kw, native = TEXT_CASES[case]
    rep, regs = run_stream_file(packed, [log], _cfg(**kw), native=native, topk=TOPK,
                                return_state=True)
    if native:
        ensure_reference_native()
    ck = tmp_path / "ref"
    jrep = rstream.run_stream_file(
        rpacked, [log], _jcfg(**kw, checkpoint_every_chunks=1 << 20, checkpoint_dir=str(ck)),
        native=native, topk=TOPK, mesh=mesh1())
    assert _strip(rep) == _strip(jrep)
    jregs = rckpt.load(str(ck)).arrays
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], jregs[k], err_msg=k)
        np.testing.assert_array_equal(regs[k], flat_registers[k], err_msg=f"flat {k}")
    got = {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep.per_rule if e["hits"]}
    assert got == dict(res.hits)
    assert rep.totals["lines_matched"] == res.lines_matched


def test_stacked_stdin_run_equals_the_reference(multi_fw):
    """``run_stream`` over an iterable (the CLI's ``--logs -``)."""
    packed, rpacked, _, lines, _, _ = multi_fw
    rep = run_stream(packed, iter(lines), _cfg(stacked_lane=50), topk=TOPK)
    jrep = rstream.run_stream(rpacked, iter(lines), _jcfg(stacked_lane=50), topk=TOPK,
                              mesh=mesh1())
    assert _strip(rep) == _strip(jrep)
    assert rep.totals["lines_total"] == len(lines)


def test_cli_stacked_run_equals_the_api_run(multi_fw, tmp_path):
    packed, _, _, _, log, d = multi_fw
    out = tmp_path / "rep.json"
    rc = cli.main(["run", "--ruleset", str(d / "fw"), "--logs", log, "--device", "cpu",
                   "--batch-size", str(B), "--cms-width", str(SKETCH["cms_width"]),
                   "--hll-p", str(SKETCH["hll_p"]), "--match-impl", "scan",
                   "--layout", "stacked", "--stacked-lane", "64", "--topk", str(TOPK),
                   "--json", "--out", str(out)])
    assert rc == 0
    rep = run_stream_file(packed, [log], _cfg(stacked_lane=64), topk=TOPK)
    got = json.loads(out.read_text())
    for k in VOLATILE_TOTALS + ("backend",):
        got["totals"].pop(k, None)
    assert got == _strip(rep)


# --- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("argv, reason", [
    (["--layout", "stacked", "--match-impl", "fused"],
     "match_impl='fused' supports layout='flat' only"),
    (["--layout", "stacked", "--match-impl", "scan", "--stacked-lane", "-1"],
     "stacked_lane must be >= 0"),
    (["--layout", "stacked", "--backend", "oracle"],
     "--layout=stacked only apply to --backend=tpu"),
])
def test_cli_refusals_exit_2_with_the_references_reason(multi_fw, capsys, argv, reason):
    _, _, _, _, log, d = multi_fw
    rc = cli.main(["run", "--ruleset", str(d / "fw"), "--logs", log, "--device", "cpu",
                   "--acl-configs", str(d / "none.cfg"), *argv])
    assert rc == 2
    assert reason in capsys.readouterr().err


def test_config_refusals_match_the_references():
    with pytest.raises(ValueError, match="layout must be 'flat' or 'stacked'"):
        AnalysisConfig(layout="grouped")
    with pytest.raises(ValueError, match="stacked_lane must be >= 0"):
        AnalysisConfig(stacked_lane=-1)
    with pytest.raises(ValueError, match="supports layout='flat' only"):
        AnalysisConfig(layout="stacked", match_impl="fused")
    with pytest.raises(ValueError, match="supports layout='flat' only"):
        JConfig(layout="stacked", match_impl="pallas_fused")
    AnalysisConfig(layout="stacked", match_impl="scan", coalesce="on")


# --- checkpoint/resume --------------------------------------------------------


@pytest.mark.parametrize("lane", [0, 64])
def test_fingerprint_is_the_references(multi_fw, lane):
    packed, rpacked = multi_fw[:2]
    resolved = lane or B // packed.n_acls
    mine = ckpt.fingerprint(packed, _cfg(stacked_lane=lane), resolved)
    assert mine == rckpt.fingerprint(rpacked, _jcfg(stacked_lane=lane), 1, resolved)
    assert mine != ckpt.fingerprint(packed, _cfg(layout="flat"))


def test_kill_and_resume_equals_the_run_with_the_same_cadence(multi_fw, tmp_path):
    """The reference's stacked crash/resume (every chunk, killed after 3
    source batches), held to the uninterrupted port and reference runs
    saved on the same cadence: each save steps what the buffer holds."""
    packed, rpacked, _, lines, _, _ = multi_fw
    full = run_stream(packed, iter(lines), _cfg(checkpoint_every_chunks=1,
                                                checkpoint_dir=str(tmp_path / "full")),
                      topk=TOPK)
    jfull = rstream.run_stream(rpacked, iter(lines), _jcfg(
        checkpoint_every_chunks=1, checkpoint_dir=str(tmp_path / "ref")), topk=TOPK,
        mesh=mesh1())
    ck = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_every_chunks=1, checkpoint_dir=ck)
    crashed = run_stream(packed, iter(lines), cfg, topk=TOPK, max_chunks=3)
    snap = ckpt.load(ck)
    assert snap is not None and snap.lines_consumed == 3 * B
    assert crashed.totals["lines_total"] == 3 * B
    rep, regs = run_stream(packed, iter(lines), dataclasses.replace(cfg, resume=True),
                           topk=TOPK, return_state=True)
    assert _strip(rep) == _strip(full) == _strip(jfull)
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], jregs[k], err_msg=k)


@pytest.mark.parametrize("direction", ["port-resumes-reference", "reference-resumes-port"])
def test_each_package_resumes_the_others_stacked_snapshot(multi_fw, tmp_path, direction):
    packed, rpacked, _, lines, _, _ = multi_fw
    every = dict(checkpoint_every_chunks=2)
    jfull = rstream.run_stream(rpacked, iter(lines), _jcfg(
        **every, checkpoint_dir=str(tmp_path / "ref")), topk=TOPK, mesh=mesh1())
    ck = str(tmp_path / "ck")
    if direction == "port-resumes-reference":
        rstream.run_stream(rpacked, iter(lines), _jcfg(**every, checkpoint_dir=ck),
                           topk=TOPK, mesh=mesh1(), max_chunks=5)
        assert rckpt.load(ck).n_chunks > 0
        rep = run_stream(packed, iter(lines), _cfg(**every, checkpoint_dir=ck, resume=True),
                         topk=TOPK)
    else:
        run_stream(packed, iter(lines), _cfg(**every, checkpoint_dir=ck), topk=TOPK,
                   max_chunks=5)
        assert ckpt.load(ck).n_chunks > 0
        rep = rstream.run_stream(rpacked, iter(lines), _jcfg(**every, checkpoint_dir=ck,
                                                              resume=True),
                                 topk=TOPK, mesh=mesh1())
    assert _strip(rep) == _strip(jfull)
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    for k, v in rckpt.load(ck).arrays.items():
        np.testing.assert_array_equal(v, jregs[k], err_msg=k)


@pytest.mark.parametrize("saved, resumed", [("flat", "stacked"), ("stacked", "flat")])
def test_layouts_never_cross_resume(multi_fw, tmp_path, saved, resumed):
    packed, _, _, lines, _, _ = multi_fw
    ck = str(tmp_path / "ck")
    run_stream(packed, iter(lines), _cfg(layout=saved, checkpoint_every_chunks=2,
                                         checkpoint_dir=ck), topk=TOPK, max_chunks=5)
    assert ckpt.load(ck) is not None
    with pytest.raises(CheckpointMismatch, match="layout"):
        run_stream(packed, iter(lines), _cfg(layout=resumed, checkpoint_every_chunks=2,
                                             checkpoint_dir=ck, resume=True), topk=TOPK)
