"""The port's durable epoch store against the reference's.

Counterparts of the nine cases of ``tests/test_epochstore.py``, each run
through both packages over the same epochs (the reference suite's
``_mk_epoch``), with the reference's own assertions on the port and the
two packages' answers held equal:

- fold-shape independence: tree == naive == one-shot, in each package
  and across them;
- the range degenerates and unix-second resolution, the quarantined gap,
  the key-space migration era and its holes, reopen and repair: the same
  markers, spans, summaries and registers;
- the suffix-merge cache;
- serve's range report, replay-free, end to end (a ``tail0:`` spool): the
  port's ``/report/range`` body is the reference's rendering of the same
  store;
- the two chaos cases with the same fault plans: a failing spill
  degrades the store and leaves it readable; a kill mid-compaction loses
  no epoch.

Beyond them: each level's chain file (and every other file of the store)
is byte-identical between the packages, each package opens the other's
store and folds it to the same bits, and ``pack_epoch_payload`` gives the
same bytes in both, whose three corruptions each package refuses alike.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.parallel import distributed as rdist  # noqa: E402
from ruleset_analysis_tpu.runtime import epochstore as repochstore  # noqa: E402
from ruleset_analysis_tpu.runtime import serve as rserve  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import distributed  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import epochstore, serve  # noqa: E402
from tests._torch_servekit import (  # noqa: E402
    PORT, REF, SIDES, get_json, get_text, http_code, norm, serve_run, wait_for,
    write_lines,
)
from tests.test_epochstore import _mk_epoch  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CFG = dict(batch_size=128, prefetch_depth=0)
WL = 150
#: each package's epoch-store module and the error its refusals raise
STORES = {"ref": (repochstore, RAnalysisError), "port": (epochstore, AnalysisError)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def agg_image(agg) -> tuple:
    """An aggregate of either package as plain values."""
    return (tuple(agg.span), {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in
                              sorted(agg.arrays.items())},
            agg.summary, agg.tables, agg.quarantine)


def run_image(agg) -> tuple:
    """:func:`agg_image` without the wall stamps of the windows' runs."""
    span, arrays, summary, tables, quarantine = agg_image(agg)
    summary = {k: v for k, v in summary.items() if k not in ("started_unix", "ended_unix")}
    return span, arrays, summary, tables, quarantine


def _agg_equal(a, b) -> bool:
    return agg_image(a) == agg_image(b)


def tree_files(d: str) -> dict:
    """Every file of a store directory: relative path -> bytes."""
    out = {}
    for root, _dirs, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.fixture(scope="module")
def stores64(tmp_path_factory):
    """Both packages' stores over the 64 epochs of the reference suite."""
    td = tmp_path_factory.mktemp("tepochstore")
    dirs = {}
    for name, (mod, _err) in STORES.items():
        d = str(td / name)
        store = mod.EpochStore(d)
        store.bind_base(0)
        for w in range(64):
            assert store.spill(_mk_epoch(w))
        store.close()
        dirs[name] = d
    return dirs


# ---------------------------------------------------------------------------
# Offline store: fold-shape independence and the typed refusals.
# ---------------------------------------------------------------------------


def test_fold_shape_independence_tree_naive_oneshot(stores64):
    opened = {name: STORES[name][0].EpochStore(d) for name, d in stores64.items()}
    eps = [_mk_epoch(w) for w in range(64)]
    rng = np.random.default_rng(5)
    try:
        for _ in range(24):
            lo = int(rng.integers(0, 63))
            hi = int(rng.integers(lo, 64))
            images = {}
            for name, store in opened.items():
                mod = STORES[name][0]
                tree, m1 = store.range_agg(lo, hi)
                naive, m2 = store.naive_range_agg(lo, hi)
                assert m1 is None and m2 is None
                assert _agg_equal(tree, naive), f"{name}: tree != naive on [{lo},{hi}]"
                one = mod.agg_from_epoch(eps[lo])
                for ep in eps[lo + 1:hi + 1]:
                    one = mod.merge_aggs(one, mod.agg_from_epoch(ep))
                assert _agg_equal(tree, one), f"{name}: tree != one-shot on [{lo},{hi}]"
                images[name] = agg_image(tree)
            assert images["port"] == images["ref"], f"port != reference on [{lo},{hi}]"
        stats = {name: store.stats() for name, store in opened.items()}
        assert stats["port"]["depth"] >= 6
        for s in stats.values():
            s.pop("dir")
        assert stats["port"] == stats["ref"]
    finally:
        for store in opened.values():
            store.close()


def test_chain_files_byte_identical(stores64):
    """Every level's chain segments, the manifest and the spill index."""
    port, ref = tree_files(stores64["port"]), tree_files(stores64["ref"])
    assert sorted(port) == sorted(ref)
    assert any(name.startswith("L06") for name in port), sorted(port)
    for name in sorted(ref):
        assert port[name] == ref[name], f"{name} differs"


def test_each_package_folds_the_others_store(stores64):
    for reader, writer in (("port", "ref"), ("ref", "port")):
        theirs = STORES[reader][0].EpochStore(stores64[writer])
        own = STORES[writer][0].EpochStore(stores64[writer])
        try:
            for lo, hi in ((0, 63), (5, 40), (17, 17), (32, 63)):
                a, ma = theirs.range_agg(lo, hi)
                b, mb = own.range_agg(lo, hi)
                assert ma is None and mb is None
                assert _agg_equal(a, b), f"{reader} reading {writer}'s store on [{lo},{hi}]"
                n, _ = theirs.naive_range_agg(lo, hi)
                assert _agg_equal(n, b)
            assert theirs.frontier() == own.frontier()
        finally:
            theirs.close()
            own.close()


def test_epoch_payload_bytes_and_refusals():
    ep = _mk_epoch(7)
    extra = {"level": 0, "span": [7, 8], "summary": {"windows": 1, "lines": 107},
             "tables": {"0": {"5": 9}}, "quarantine": [["fw1", "acl0", 0, "line", 8]]}
    raw = distributed.pack_epoch_payload(ep.arrays, extra)
    assert raw == rdist.pack_epoch_payload(ep.arrays, extra)
    assert raw[:5] == b"RAEP1"
    for unpack in (distributed.unpack_epoch_payload, rdist.unpack_epoch_payload):
        arrays, meta = unpack(raw)
        assert meta == extra
        assert {k: (v.dtype, v.tobytes()) for k, v in arrays.items()} == \
            {k: (v.dtype, v.tobytes()) for k, v in ep.arrays.items()}
    flipped = bytearray(raw)
    flipped[40] ^= 0xFF
    corrupt = {"magic": b"RAEPX" + raw[5:], "truncated": raw[:-3],
               "crc": bytes(flipped)}
    for what, bad in corrupt.items():
        msgs = []
        for unpack, err in ((distributed.unpack_epoch_payload, AnalysisError),
                            (rdist.unpack_epoch_payload, RAnalysisError)):
            with pytest.raises(err) as e:
                unpack(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], what
        assert {"magic": "RAEP1 magic", "truncated": "truncated",
                "crc": "CRC mismatch"}[what] in msgs[0]


def _degenerates(mod, err, d: str) -> list:
    store = mod.EpochStore(d)
    out = []
    _, m = store.range_agg(0, 5)
    assert m["range_incomplete"] and m["reason"] == "empty_store"
    out.append(m)
    store.bind_base(10)
    for w in range(10, 17):
        store.spill(_mk_epoch(w))
    agg, m = store.range_agg(12, 12)
    assert m is None and agg.span == (12, 13) and agg.summary["windows"] == 1
    out.append(agg_image(agg))
    _, m = store.range_agg(14, 12)
    assert m["range_incomplete"] and m["reason"] == "empty_range"
    out.append(m)
    _, m = store.range_agg(10, 99)
    assert m["reason"] == "beyond_frontier" and m["window"] == 17
    out.append(m)
    _, m = store.range_agg(2, 12)
    assert m["reason"] == "missing"
    out.append(m)
    agg, m = store.range_agg(None, None)
    assert m is None and agg.span == (10, 17)
    out.append(agg_image(agg))
    lo, hi = store.resolve_range(str(_mk_epoch(12).meta["started_unix"]),
                                 str(_mk_epoch(14).meta["ended_unix"]))
    assert (lo, hi) == (12, 14)
    out.append(store.resolve_range("1800000000", "1"))
    with pytest.raises(err) as e:
        store.resolve_range("not-a-number", None)
    out.append(str(e.value))
    out.append({k: v for k, v in store.stats().items() if k != "dir"})
    store.close()
    return out


def test_range_degenerates_and_unix_resolution(tmp_path):
    got = {name: _degenerates(mod, err, str(tmp_path / name))
           for name, (mod, err) in STORES.items()}
    assert got["port"] == got["ref"]


def _quarantined_gap(mod, d: str) -> list:
    store = mod.EpochStore(d)
    store.bind_base(0)
    for w in range(8):
        store.spill(_mk_epoch(w))
    expect_full, m = store.range_agg(0, 7)
    assert m is None
    store.close()
    # flip one payload byte of a level-0 record (all 8 fit one segment)
    l0 = os.path.join(d, "L00")
    seg = os.path.join(l0, sorted(os.listdir(l0))[0])
    with open(seg, "r+b") as f:
        f.seek(os.path.getsize(seg) - 40)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    store = mod.EpochStore(d)
    store.bind_base(8)
    _, m = store.range_agg(7, 7)
    assert m == {"range_incomplete": True, "from": 7, "to": 7, "reason": "missing",
                 "window": 7}
    assert store.range_incomplete_total == 1
    assert store.stats()["quarantined_segments"] >= 1
    # the aligned full span rides the intact level-3 node
    agg, m = store.range_agg(0, 7)
    assert m is None and _agg_equal(agg, expect_full)
    out = [m, agg_image(agg), {k: v for k, v in store.stats().items() if k != "dir"}]
    store.close()
    return out


def test_quarantined_gap_refuses_typed_but_coarse_spans_answer(tmp_path):
    got = {name: _quarantined_gap(mod, str(tmp_path / name))
           for name, (mod, _err) in STORES.items()}
    assert got["port"] == got["ref"]


def _era(mod, d: str) -> list:
    store = mod.EpochStore(d)
    store.bind_base(0)
    for w in range(3):
        store.spill(_mk_epoch(w))
    store.mark_era(3, generation=1)
    for w in range(3, 6):
        store.spill(_mk_epoch(w))
    _, m = store.range_agg(1, 4)
    assert m["range_incomplete"] and m["reason"] == "keyspace_migration"
    assert m["window"] == 2
    agg, m2 = store.range_agg(3, 5)
    ref, _ = store.naive_range_agg(3, 5)
    assert m2 is None and _agg_equal(agg, ref)
    assert store.holes_total >= 1
    out = [m, agg_image(agg), store.eras, store.holes_total,
           {k: v for k, v in store.stats().items() if k != "dir"}]
    store.close()
    return out


def test_keyspace_migration_era_refusal_and_holes(tmp_path):
    got = {name: _era(mod, str(tmp_path / name)) for name, (mod, _err) in STORES.items()}
    assert got["port"] == got["ref"]
    assert tree_files(str(tmp_path / "port")) == tree_files(str(tmp_path / "ref"))


def _reopen(mod, err, d: str) -> list:
    store = mod.EpochStore(d)
    store.bind_base(0)
    for w in range(13):
        store.spill(_mk_epoch(w))
    want, _ = store.naive_range_agg(0, 12)
    stats = store.stats()
    store.close()
    again = mod.EpochStore(d)
    again.bind_base(13)
    assert again.stats()["epochs"] == 13
    assert again.stats()["nodes"] == stats["nodes"]
    agg, m = again.range_agg(0, 12)
    assert m is None and _agg_equal(agg, want)
    with pytest.raises(err) as e:
        again.bind_base(20)
    out = [agg_image(agg), stats["nodes"], str(e.value).replace(d, "<dir>")]
    again.close()
    return out


def test_reopen_repair_preserves_fold_and_counts(tmp_path):
    got = {name: _reopen(mod, err, str(tmp_path / name))
           for name, (mod, err) in STORES.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Suffix-merge cache (merged-K rendering reuse).
# ---------------------------------------------------------------------------


def test_suffix_cache_bit_identical_and_self_healing():
    eps = [_mk_epoch(w) for w in range(10)]
    caches = {"port": serve.SuffixMergeCache((3,)), "ref": rserve.SuffixMergeCache((3,))}
    for i, ep in enumerate(eps):
        ids = [e.meta["id"] for e in eps[max(0, i - 2):i + 1]]
        want = serve.merge_register_arrays([e.arrays for e in eps[max(0, i - 2):i + 1]])
        for sc in caches.values():
            sc.push(ep.meta["id"], ep.arrays)
            got = sc.merged(3, ids)
            assert got is not None
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for sc in caches.values():
        assert sc.merged(3, [99, 8, 9]) is None
        sc.invalidate()
        assert sc.merged(3, [7, 8, 9]) is None
        for ep in eps[8:]:
            sc.push(ep.meta["id"], ep.arrays)
        got = sc.merged(3, [8, 9])
        want = serve.merge_register_arrays([eps[8].arrays, eps[9].arrays])
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert sc.misses == 2 and sc.hits == 11


# ---------------------------------------------------------------------------
# Serve end to end: a spill every rotation, /report/range == cumulative.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference suite's corpus: 2 ACLs x 8 rules (25% v6), 500 lines."""
    td = tmp_path_factory.mktemp("tepochserve")
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=0, v6_fraction=0.25)
    packed = PORT.packed(cfg_text, "fw1")
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 500, seed=1), seed=1)
    return {"prefix": prefix, "lines": lines, "cfg_text": cfg_text}


def test_serve_range_report_replay_free_e2e(corpus, tmp_path):
    """Three windows of a ring of two: the store answers the whole span
    replay-free, as the cumulative view; the reference, reading the port's
    store, renders the same report; a fresh open answers after the run."""
    es_dir = str(tmp_path / "estore")
    spool = str(tmp_path / "spool.log")
    write_lines(spool, corpus["lines"][:3 * WL])

    def script(drv, http):
        wait_for(lambda: drv.windows_published >= 3, 60, "three windows")
        return {
            "full": get_json(http, "/report/range?from=0&to=2"),
            "cum": get_json(http, "/report/cumulative"),
            "one": get_json(http, "/report/range?from=1&to=1"),
            "win1": get_json(http, "/report/window/1"),
            "future": http_code(http, "/report/range?from=0&to=9"),
            "lasthit": get_json(http, "/report/last-hit"),
            "metrics": get_json(http, "/metrics"),
            "prom": get_text(http, "/metrics?format=prom"),
            "lineage": drv.lineage_tail(),
        }

    scfg = PORT.scfg(listen=(f"tail0:{spool}",), window_lines=WL, ring=2,
                     serve_dir=str(tmp_path / "serve"), max_windows=0, stop_after_sec=90,
                     reload_watch=False, checkpoint_every_windows=0, http="127.0.0.1:0",
                     queue_lines=10_000, epoch_store=es_dir)
    run = serve_run(PORT, corpus["prefix"], PORT.cfg(**RUN_CFG), scfg, script)
    b = run.http
    full, cum = b["full"], b["cum"]
    assert "range_incomplete" not in full
    assert full["per_rule"] == cum["per_rule"]
    assert full["totals"]["lines_total"] == cum["totals"]["lines_total"] == 3 * WL
    win = full["totals"]["window"]
    assert win["range"] == [0, 2] and win["windows"] == 3
    assert win["drops"] == 0 and "incomplete" not in win
    assert win["mode"] == "lines" and win["length"] == WL
    assert b["one"]["per_rule"] == b["win1"]["per_rule"]
    code, marker = b["future"]
    assert code == 404 and marker["range_incomplete"] and marker["reason"] == "beyond_frontier"
    assert b["lasthit"]["frontier"] == 2 and b["lasthit"]["rules"]
    m = b["metrics"]
    assert m["epochstore_spilled_total"] == 3 and m["epochstore_epochs"] == 3
    assert m["epochstore_range_queries_total"] >= 3
    assert "ra_serve_epochstore_spilled_total 3" in b["prom"]
    assert "ra_serve_range_query_seconds_count" in b["prom"]
    assert b["lineage"]["epoch_store"]["last_spilled_window"] == 2
    assert run.summary["epoch_store"]["epochs"] == 3 and run.summary["drops"] == 0

    # the reference opens the port's store and renders the same span
    rstore = repochstore.EpochStore(es_dir)
    try:
        ragg, rm = rstore.range_agg(0, 2)
        assert rm is None and ragg.summary["windows"] == 3
        assert ragg.summary["lines"] == run.summary["lines_total"]
        rpacked = REF.packed(corpus["cfg_text"], "fw1")
        want = json.loads(rserve.render_range_report(
            ragg, rpacked, REF.cfg(**RUN_CFG), topk=10,
            window_extra={"mode": "lines", "length": WL}).to_json())
    finally:
        rstore.close()
    assert norm(full) == norm(want)
    # replay-free across the process's end: a fresh open of the port's store
    again = epochstore.EpochStore(es_dir)
    agg, m = again.range_agg(0, 2)
    again.close()
    assert m is None and agg_image(agg) == agg_image(ragg)


# ---------------------------------------------------------------------------
# Chaos: a failing spill, and a kill mid-compaction.
# ---------------------------------------------------------------------------


def test_chaos_spill_raise_degrades_and_store_stays_readable(corpus, tmp_path):
    runs = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        spool = str(d / "spool.log")
        write_lines(spool, corpus["lines"][:3 * WL])
        es_dir = str(d / "estore")
        scfg = side.scfg(listen=(f"tail0:{spool}",), window_lines=WL, ring=4,
                         serve_dir=str(d / "serve"), max_windows=3, stop_after_sec=60,
                         reload_watch=False, checkpoint_every_windows=0, http="off",
                         queue_lines=10_000, epoch_store=es_dir)
        run = serve_run(side, corpus["prefix"],
                        side.cfg(**RUN_CFG, fault_plan="epochstore.spill@2"), scfg)
        summary = run.summary
        assert summary["windows_published"] == 3
        assert "epoch_store" in summary["degraded"]
        assert summary["epoch_store"]["epochs"] == 1
        mod = STORES[side.name][0]
        store = mod.EpochStore(es_dir)
        agg, m = store.range_agg(0, 0)
        assert m is None and agg.summary["windows"] == 1
        _, m2 = store.range_agg(0, 2)
        assert m2["range_incomplete"] and m2["reason"] == "beyond_frontier"
        store.close()
        # the level-0 node carries the window's meta, wall stamps included,
        # whose printed length varies from run to run
        summary["epoch_store"].pop("dir")
        summary["epoch_store"].pop("bytes")
        runs[side.name] = (norm(summary), run_image(agg), m2)
    assert runs["port"] == runs["ref"]


_CRASH_CHILD = (
    "import sys\n"
    "from tests.test_epochstore import _mk_epoch\n"
    "if sys.argv[2] == 'port':\n"
    "    from ruleset_analysis_tpu_torch.runtime import epochstore\n"
    "else:\n"
    "    from ruleset_analysis_tpu.runtime import epochstore\n"
    "store = epochstore.EpochStore(sys.argv[1])\n"
    "store.bind_base(0)\n"
    "for w in range(12):\n"
    "    store.spill(_mk_epoch(w))\n"
    "    print(w, flush=True)\n"
)


def test_chaos_compact_crash_loses_zero_epochs(tmp_path):
    """os._exit after the pair is chosen, before the merged node lands:
    each package's reopen sees every epoch whose spill started, repair
    rebuilds the unwritten summary node, and the two stores are the same
    bytes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", RA_FAULT_PLAN="epochstore.compact@2")
    got = {}
    for name, (mod, _err) in STORES.items():
        es_dir = str(tmp_path / name)
        proc = subprocess.run([sys.executable, "-c", _CRASH_CHILD, es_dir, name],
                              capture_output=True, text=True, timeout=300, cwd=_REPO, env=env)
        assert proc.returncode != 0, f"{name}: the crash plan never fired"
        acked = [int(x) for x in proc.stdout.split()]
        assert acked, f"{name}: no spill acked before the crash: {proc.stderr[-500:]}"
        store = mod.EpochStore(es_dir)
        st = store.stats()
        assert st["epochs"] == len(acked) + 1, (name, st, acked)
        agg, m = store.range_agg(0, st["epochs"] - 1)
        naive, mn = store.naive_range_agg(0, st["epochs"] - 1)
        assert m is None and mn is None and _agg_equal(agg, naive)
        assert agg.summary["windows"] == st["epochs"]
        store.close()
        st.pop("dir")
        got[name] = (proc.returncode, acked, st, agg_image(agg))
    assert got["port"] == got["ref"]
    assert tree_files(str(tmp_path / "port")) == tree_files(str(tmp_path / "ref"))
