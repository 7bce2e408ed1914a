"""The port's serve against the reference's, case by case.

Counterparts of ``tests/test_serve.py``: the merge law over text and wire
(and through the serve ring itself), rotations with a live reload read
over HTTP, wall-clock windows and a partial stop, ring checkpoint resume
(each package resuming the other's ring too), the migration laws, atomic
reload and a reload flush that fails, the HTTP bind failure, the missing
ruleset, the HLL band, ``diff-reports --expect-window``, WAL resume after
a hard abort and the WAL eviction gap, and the publisher's and the static
and metrics planes' degrade and recovery.

Each serve case runs the reference's driver (one-device mesh) and the
port's (CPU) over the same ``tail0:`` spool and the same scenario, and
compares their published files, HTTP bodies and ring registers
(``tests/_torch_servekit.py`` says what is stripped as volatile).  The
listener tier's own cases are in ``tests/test_torch_listener.py``, the
CLI's round trip in ``tests/test_torch_serve_cli.py``.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.errors import InjectedFault as RInjectedFault  # noqa: E402
from ruleset_analysis_tpu.hostside import wire as rwire  # noqa: E402
from ruleset_analysis_tpu.runtime import faults as rfaults  # noqa: E402
from ruleset_analysis_tpu.runtime import obs as robs  # noqa: E402
from ruleset_analysis_tpu.runtime import retrypolicy as rretry  # noqa: E402
from ruleset_analysis_tpu.runtime import serve as rserve  # noqa: E402
from ruleset_analysis_tpu.runtime.wal import WriteAheadLog as RWal  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.errors import InjectedFault  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import faults, obs, retrypolicy  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import serve  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.wal import WriteAheadLog  # noqa: E402
from tests._torch_servekit import (  # noqa: E402
    PORT, REF, SIDES, assert_same_files, assert_same_http, assert_same_ring, get_json,
    http_code, norm, registers_of, serve_run, wait_for, write_lines,
)
from tests.test_serve import NEW_CFG, OLD_CFG, _fwx_lines  # noqa: E402

RUN_CFG = dict(batch_size=128, prefetch_depth=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's serve corpus: 2 ACLs x 8 rules (25% v6 ACEs), 500 v4
    and 100 v6 lines; packed by each package, saved by the port."""
    td = tmp_path_factory.mktemp("tserve")
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=0, v6_fraction=0.25)
    packed = PORT.packed(cfg_text, "fw1")
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    t = synth.synth_tuples(packed, 500, seed=1)
    lines = synth.render_syslog(packed, t, seed=1)
    t6 = synth.synth_tuples6(packed, 100, seed=2)
    lines += synth.render_syslog6(packed, t6, seed=3)
    return {"packed": packed, "rpacked": REF.packed(cfg_text, "fw1"), "prefix": prefix,
            "lines": lines, "cfg_text": cfg_text}


@pytest.fixture(scope="module")
def fwx(tmp_path_factory):
    """The reference's reload corpus: OLD_CFG, its renumbered NEW_CFG (an
    insert and a delete), and 600 lines against both."""
    return {"old": PORT.packed(OLD_CFG, "fwx"), "new": PORT.packed(NEW_CFG, "fwx"),
            "rold": REF.packed(OLD_CFG, "fwx"), "rnew": REF.packed(NEW_CFG, "fwx"),
            "lines": _fwx_lines(600, seed=7)}


def side_dirs(tmp_path, side, packed=None):
    """A side's own directory, with its own copy of ``packed`` saved there."""
    d = tmp_path / side.name
    d.mkdir(exist_ok=True)
    if packed is not None:
        pack.save_packed(packed, str(d / "rules"))
    return d


def tail_scfg(d, *, spool="spool.log", **kw):
    base = dict(listen=(f"tail0:{d / spool}",), ring=4, serve_dir=str(d / "serve"),
                stop_after_sec=90, reload_watch=False, queue_lines=10_000)
    base.update(kw)
    return base


def side_packed(side, c, key="packed"):
    return c[key] if side is PORT else c["r" + key]


# ---------------------------------------------------------------------------
# The merge law: K merged epochs == one run over the concatenated lines.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["text", "wire"])
def test_epoch_ring_merge_law(corpus, tmp_path, kind):
    """Merging the registers of uneven segments equals the registers of one
    run over all of them, on each package, and the two packages' merged
    images are equal bit for bit; the merge is associative."""
    lines = corpus["lines"]
    cuts = [0, 150, 370, 600]
    merged = {}
    for side in SIDES:
        packed = side_packed(side, corpus)
        if kind == "wire":
            paths = []
            for i in range(3):
                log = tmp_path / f"seg{i}.log"
                write_lines(str(log), lines[cuts[i]:cuts[i + 1]])
                p = str(tmp_path / f"{side.name}-seg{i}.rawire")
                (wire if side is PORT else rwire).convert_logs(packed, [str(log)], p,
                                                               block_rows=256)
                paths.append(p)
            full_log = tmp_path / "full.log"
            write_lines(str(full_log), lines)
            full = str(tmp_path / f"{side.name}-full.rawire")
            (wire if side is PORT else rwire).convert_logs(packed, [str(full_log)], full,
                                                           block_rows=256)

            def regs(p, ck):
                cfg = side.cfg(**RUN_CFG, checkpoint_every_chunks=10_000, checkpoint_dir=ck)
                side.run_stream_wire(packed, p, cfg)
                return side.ckpt.load(ck).arrays

            segs = [regs(p, str(tmp_path / f"{side.name}-ck{i}")) for i, p in enumerate(paths)]
            whole = regs(full, str(tmp_path / f"{side.name}-ckf"))
        else:
            segs = [registers_of(side, packed, lines[cuts[i]:cuts[i + 1]], RUN_CFG,
                                 str(tmp_path / f"{side.name}-ck{i}")) for i in range(3)]
            whole = registers_of(side, packed, lines, RUN_CFG, str(tmp_path / f"{side.name}-ckf"))
        m = side.serve.merge_register_arrays(segs)
        for field in whole:
            assert np.array_equal(m[field], whole[field]), f"{side.name} {kind}: {field}"
        left = side.serve.merge_register_arrays(
            [side.serve.merge_register_arrays(segs[:2]), segs[2]])
        right = side.serve.merge_register_arrays(
            [segs[0], side.serve.merge_register_arrays(segs[1:])])
        for field in left:
            assert np.array_equal(left[field], right[field])
        merged[side.name] = m
    for field in merged["ref"]:
        assert merged["ref"][field].dtype == merged["port"][field].dtype
        assert np.array_equal(merged["ref"][field], merged["port"][field]), field


def test_serve_ring_merge_equals_one_run(corpus, tmp_path):
    """Through the serve loop itself: the port's four ring epochs over the
    corpus, merged, are the registers of one port run over all its lines,
    and the ring equals the reference's ring epoch for epoch."""
    lines = corpus["lines"]
    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "spool.log"), lines)
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**RUN_CFG),
            side.scfg(**tail_scfg(d, window_lines=150, max_windows=4,
                                  checkpoint_every_windows=0, http="off")))
    assert_same_ring(runs["ref"], runs["port"])
    assert_same_files(runs["ref"], runs["port"])
    whole = registers_of(PORT, corpus["packed"], lines, RUN_CFG, str(tmp_path / "ckw"))
    merged = serve.merge_register_arrays([arrays for _m, arrays, _t, _q in runs["port"].ring])
    for field in whole:
        assert np.array_equal(merged[field], whole[field]), field


# ---------------------------------------------------------------------------
# End to end: rotations, HTTP endpoint and a live reload.
# ---------------------------------------------------------------------------

HTTP_PATHS = ("/report", "/report/window/0", "/report/window/1", "/report/window/2",
              "/report/cumulative", "/diff", "/report/merged/2", "/report/merged/1",
              "/lineage", "/lineage/window/1")
HTTP_CODES = ("/report/merged/0", "/report/merged/5", "/report/merged/x", "/report/window/9",
              "/report/window/x", "/report/range", "/report/range?from=0&to=1",
              "/report/last-hit", "/report/static", "/lineage/window/7", "/nope")


def health_image(h: dict) -> dict:
    h = json.loads(json.dumps(h))
    h.pop("uptime_sec")
    h["listeners"].pop("addresses")
    return h


def test_serve_e2e_rotations_and_live_reload(fwx, tmp_path):
    """Three windows of 200 lines over a tail0 spool, a live reload of the
    renumbered ruleset halfway through window 1, every report read over
    HTTP: the two packages publish the same files and bodies and hold the
    same ring, with the reference's quarantine and window fidelity."""
    lines = fwx["lines"]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        wait_for(lambda: drv.health()["current_window"] == {"id": 1, "pushed": 100},
                 60, "w0 + half of w1")
        pack.save_packed(fwx["new"], drv.prefix)
        drv.request_reload()
        wait_for(lambda: drv.health()["reloads"] == 1, 30, "reload")
        write_lines(spool, lines[300:600], mode="a")
        wait_for(lambda: drv.window_report(2) is not None
                 and (drv.published("diff") or {}).get("windows") == [1, 2], 60, "3 windows")
        bodies = {p: get_json(http, p) for p in HTTP_PATHS}
        bodies.update({f"code {p}": http_code(http, p) for p in HTTP_CODES})
        bodies["health"] = health_image(get_json(http, "/health"))
        m = get_json(http, "/metrics")
        bodies["metrics keys"] = sorted(m)
        bodies["metrics counters"] = {k: m[k] for k in (
            "windows_published", "reloads_total", "lines_windowed_total", "drops_total",
            "lineage_records_total", "merged_suffix_hits_total", "merged_suffix_misses_total",
            "device_mem_bytes_in_use")}
        bodies["merged 3"] = drv.merged_report_obj(3)
        return bodies

    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side, fwx["old"])
        write_lines(str(d / "spool.log"), lines[:300])
        runs[side.name] = serve_run(
            side, str(d / "rules"), side.cfg(**RUN_CFG),
            side.scfg(**tail_scfg(d, window_lines=200, views=(2,))), script)
    ref, port = runs["ref"], runs["port"]
    assert_same_files(ref, port)
    assert_same_http(ref, port)
    assert_same_ring(ref, port)
    assert norm(ref.summary) == norm(port.summary)
    s = port.summary
    assert s["windows_published"] == 3 and s["drops"] == 0
    assert s["reloads"] == 1 and s["reload_errors"] == 0
    # the deleted udp rule's pre-reload hits, quarantined exactly
    q1 = port.files["window-000001.json"]["totals"]["quarantine"]
    assert q1["rules"][0]["rule"] == "fwx A 2" and q1["hits"] > 0
    assert port.http["/diff"]["windows"] == [1, 2]
    assert port.http["/report/merged/2"]["totals"]["window"]["merged_windows"] == [1, 2]
    assert port.http["code /report/merged/5"][0] == 400
    assert port.http["code /report/range"] == (
        404, {"error": "epoch store not armed (serve --epoch-store)"})
    # windows 0 and 2 are pure: the reference's offline run over their lines
    for wid, packed, seg in ((0, fwx["rold"], lines[:200]), (2, fwx["rnew"], lines[400:])):
        want = norm(json.loads(REF.run_stream(packed, seg, REF.cfg(**RUN_CFG)).to_json()))
        got = norm(port.files[f"window-{wid:06d}.json"])
        got["totals"].pop("window")
        want["totals"].pop("window", None)
        assert got == want, f"window {wid}"


def test_serve_wallclock_windows_and_partial_stop(fwx, tmp_path):
    """Wall-clock cadence rotates with or without traffic; each published
    window is the reference's offline run over the lines it holds, and
    every line lands in exactly one window."""
    lines = fwx["lines"][:120]
    d = side_dirs(tmp_path, PORT, fwx["old"])
    write_lines(str(d / "spool.log"), lines)
    run = serve_run(PORT, str(d / "rules"), PORT.cfg(**RUN_CFG), PORT.scfg(**tail_scfg(
        d, window_sec=1.0, max_windows=2, stop_after_sec=30, checkpoint_every_windows=0,
        http="off")))
    assert run.summary["windows_published"] == 2
    names = sorted(f for f in run.files if f.startswith("window-"))
    assert len(names) == 2
    at = 0
    for name in names:
        rep = run.files[name]
        assert rep["totals"]["window"]["mode"] == "sec"
        n = rep["totals"]["lines_total"]
        want = norm(json.loads(REF.run_stream(fwx["rold"], lines[at:at + n],
                                              REF.cfg(**RUN_CFG)).to_json()))
        got = norm(rep)
        for t in (got["totals"], want["totals"]):
            t.pop("window", None)
            t.pop("lineage", None)
        if n:
            assert got == want, name
        at += n
    assert at == 120


# ---------------------------------------------------------------------------
# Ring checkpoint resume, across the two packages too.
# ---------------------------------------------------------------------------


def _resume_pair(fwx, tmp_path, first, second):
    """Windows 0-1 by ``first``, then ``second`` resumes the ring and adds
    window 2; returns the second run and what it served at once."""
    lines = fwx["lines"]
    d = tmp_path / f"{first.name}-{second.name}"
    d.mkdir()
    pack.save_packed(fwx["old"], str(d / "rules"))
    write_lines(str(d / "a.log"), lines[:200])
    write_lines(str(d / "b.log"), [])
    serve_run(first, str(d / "rules"), first.cfg(**RUN_CFG),
              first.scfg(**tail_scfg(d, spool="a.log", window_lines=100, max_windows=2)))

    def restored(drv, http):
        # the restored history is served before any new line arrives
        out = {"health": health_image(drv.health()), "report": drv.published("report"),
               "cumulative": drv.published("cumulative"), "w0": drv.window_report(0),
               "/report/window/1": get_json(http, "/report/window/1")}
        write_lines(str(d / "b.log"), lines[200:300], mode="a")
        return out

    return serve_run(second, str(d / "rules"), second.cfg(**RUN_CFG, resume=True),
                     second.scfg(**tail_scfg(d, spool="b.log", window_lines=100,
                                             max_windows=3)), restored)


@pytest.mark.parametrize("first,second", [("ref", "ref"), ("port", "port"), ("ref", "port"),
                                          ("port", "ref")])
def test_serve_ring_checkpoint_resume(fwx, tmp_path, first, second):
    """A restarted serve keeps its window history: ids continue, the
    restored windows are served at once, and the cumulative report covers
    the traffic before the restart.  Either package resumes the other's
    ring (the same on-disk format and fingerprint), and every pairing
    publishes what the reference resuming its own publishes."""
    sides = {"ref": REF, "port": PORT}
    base = _resume_pair(fwx, tmp_path, REF, REF) if (first, second) != ("ref", "ref") else None
    run = _resume_pair(fwx, tmp_path, sides[first], sides[second])
    h = run.http["health"]
    assert run.summary["windows_published"] == 3
    assert h["windows_published"] == 2 and h["window"]["ring_windows"] == [0, 1]
    assert run.http["w0"]["totals"]["window"]["id"] == 0
    lines = fwx["lines"]
    want = norm(json.loads(REF.run_stream(fwx["rold"], lines[:100], REF.cfg(**RUN_CFG)).to_json()))
    got = norm(run.http["w0"])
    got["totals"].pop("window")
    want["totals"].pop("window", None)
    assert got == want
    cum = run.files["cumulative.json"]
    off = json.loads(REF.run_stream(fwx["rold"], lines[:300], REF.cfg(**RUN_CFG)).to_json())
    assert cum["per_rule"] == off["per_rule"] and cum["unused"] == off["unused"]
    if base is not None:
        assert_same_files(base, run)
        assert_same_http(base, run)
        assert_same_ring(base, run)


def test_serve_resume_refuses_another_ruleset(fwx, tmp_path):
    d = tmp_path / "p"
    d.mkdir()
    pack.save_packed(fwx["old"], str(d / "rules"))
    write_lines(str(d / "a.log"), fwx["lines"][:100])
    serve_run(PORT, str(d / "rules"), PORT.cfg(**RUN_CFG),
              PORT.scfg(**tail_scfg(d, spool="a.log", window_lines=100, max_windows=1)))
    pack.save_packed(fwx["new"], str(d / "other"))
    write_lines(str(d / "b.log"), [])
    run = serve_run(PORT, str(d / "other"), PORT.cfg(**RUN_CFG, resume=True),
                    PORT.scfg(**tail_scfg(d, spool="b.log", window_lines=100, max_windows=3)),
                    expect_error=ckpt.CheckpointMismatch)
    assert run.summary is None


# ---------------------------------------------------------------------------
# Migration laws: renumber / insert / delete, quarantine exact.
# ---------------------------------------------------------------------------


def _migrate_both(old_text, new_text, fill):
    out = {}
    for side in SIDES:
        old, new = side.packed(old_text, "fwx"), side.packed(new_text, "fwx")
        cfg = side.cfg(**RUN_CFG)
        mig = side.serve.build_migration(old, new)
        arrays = side.serve.zero_arrays(old.n_keys, cfg)
        fill(arrays, old)
        tables = {old.acl_gid[("fwx", "A")]: {123: 9},
                  0x80000000 | old.acl_gid[("fwx", "A")]: {77: 4}} \
            if ("fwx", "A") in old.acl_gid else {}
        out[side.name] = (mig, *side.serve.migrate_arrays(arrays, mig, old, cfg),
                          side.serve.migrate_tracker_tables(tables, mig))
    return out


def _fill_identity(arrays, old):
    arrays["counts_lo"][:] = 7


def _fill_distinct(arrays, old):
    hits = np.arange(1, old.n_keys + 1, dtype=np.uint32)
    arrays["counts_lo"][:] = hits
    arrays["hll"][:, 0] = hits


def _fill_carry(arrays, old):
    arrays["counts_lo"][1] = 0xFFFFFFFF
    arrays["counts_hi"][1] = 3
    arrays["counts_lo"][0] = 5


GONE_B = "hostname fwx\naccess-list B extended permit ip any any\n"


@pytest.mark.parametrize("case", ["identity", "renumber_insert_delete", "carry_64bit",
                                  "tracker_regid", "acl_gone"])
def test_migration_laws(case):
    """build_migration, migrate_arrays and migrate_tracker_tables give the
    reference's map, image, quarantine and talker tables."""
    old_text, new_text, fill = {
        "identity": (OLD_CFG, OLD_CFG, _fill_identity),
        "renumber_insert_delete": (OLD_CFG, NEW_CFG, _fill_distinct),
        "carry_64bit": (OLD_CFG, NEW_CFG, _fill_carry),
        "tracker_regid": (OLD_CFG, NEW_CFG, _fill_distinct),
        "acl_gone": (OLD_CFG, GONE_B, _fill_distinct),
    }[case]
    got = _migrate_both(old_text, new_text, fill)
    (mr, ar, qr, tr), (mp, ap, qp, tp) = got["ref"], got["port"]
    assert np.array_equal(mr.key_map, mp.key_map) and mr.gid_map == mp.gid_map
    assert mr.identity == mp.identity and mr.tenant == mp.tenant
    assert qr == qp and tr == tp
    for k in ar:
        assert ap[k].dtype == ar[k].dtype and np.array_equal(ap[k], ar[k]), k
    if case == "identity":
        assert mp.identity and qp == {}
    if case == "renumber_insert_delete":
        assert list(mp.key_map[:3]) == [1, -1, 2]
        assert int(ap["counts_lo"].sum()) + sum(qp.values()) == sum(range(1, mp.old_n_keys + 1))
    if case == "carry_64bit":
        key = ("fwx", "A", 2, "access-list A extended permit udp any host 10.0.0.6 eq 53")
        assert qp[key] == (3 << 32) + 0xFFFFFFFF
    if case == "acl_gone":
        assert tp == ({}, 2)


def test_quarantine_totals_and_window_incomplete_helpers():
    q = {("fw", "A", 2, "t2"): 5, ("fw", "A", 1, "t1"): 3}
    assert serve._quarantine_totals(q) == rserve._quarantine_totals(q)
    assert serve._quarantine_totals({}) is None
    dst, rdst = {("fw", "A", 1, "t1"): 1}, {("fw", "A", 1, "t1"): 1}
    serve._merge_quarantine(dst, q)
    rserve._merge_quarantine(rdst, q)
    assert dst == rdst
    rep = {"totals": {"window": {"incomplete": {"drops": 2}}}}
    assert serve.window_incomplete(rep) == rserve.window_incomplete(rep) == {"drops": 2}
    assert serve.window_incomplete({"totals": {}}) is None


@pytest.mark.parametrize("views,pushes", [((2,), 5), ((3, 1), 7), ((4,), 2)])
def test_suffix_merge_cache_matches_the_fold(corpus, tmp_path, views, pushes):
    """The merged-K suffix cache answers only for the ring's exact window
    ids, and its answer is the full fold's, bit for bit."""
    rng = np.random.default_rng(len(views) * 10 + pushes)
    cfg = PORT.cfg(**RUN_CFG)
    ring = serve.WindowRing(max(views))
    cache = serve.SuffixMergeCache(views)
    for wid in range(pushes):
        arrays = serve.zero_arrays(5, cfg)
        for k in arrays:
            arrays[k] = rng.integers(0, 2**32, arrays[k].shape, dtype=np.uint64).astype(np.uint32)
        ring.push(serve.WindowEpoch(arrays=arrays, meta={"id": wid}, tracker_tables={}))
        cache.push(wid, arrays)
        for k in views:
            eps = ring.last(k)
            got = cache.merged(k, [ep.meta["id"] for ep in eps])
            want = serve.merge_register_arrays([ep.arrays for ep in eps])
            assert got is not None
            for f in want:
                assert np.array_equal(got[f], want[f])
    assert cache.merged(max(views), [99]) is None
    cache.invalidate()
    assert cache.merged(views[0], ring.window_ids()[-views[0]:]) is None


def test_a_drop_before_the_first_window_opens_marks_it(corpus, tmp_path, monkeypatch):
    """A fault of the reference the port does not reproduce: the reference
    takes window 0's drop baseline after its listeners start, so a line
    dropped in between is counted in the summary and marks no window; the
    port takes it before they start.  Forced here: the first window opens
    only once the listener has read (and dropped) the whole spool."""
    lines = corpus["lines"][:101]
    runs = {}
    for side in SIDES:
        cls = side.serve.ServeDriver
        opened = cls._begin_window

        def held(self, opened=opened):
            if not hasattr(self, "tracker"):
                wait_for(lambda: self.queue.snapshot()["received"] == len(lines), 30,
                         "the spool read")
            opened(self)

        monkeypatch.setattr(cls, "_begin_window", held)
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "spool.log"), lines)
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**RUN_CFG, fault_plan="listener.drop@3"),
            side.scfg(**tail_scfg(d, window_lines=100, max_windows=1, http="off",
                                  checkpoint_every_windows=0)))
    for name, want in (("port", {"drops": 1, "reasons": ["dropped_lines"]}), ("ref", None)):
        run = runs[name]
        assert run.summary["drops"] == 1 and run.summary["windows_published"] == 1
        assert serve.window_incomplete(run.files["window-000000.json"]) == want, name


# ---------------------------------------------------------------------------
# Atomic reload and the reload flush's step failure.
# ---------------------------------------------------------------------------


def test_reload_failure_is_atomic(fwx, tmp_path):
    """reload.midbatch fires: the old tensors and counters keep serving,
    both windows are the reference's and the no-reload run's."""
    lines = fwx["lines"]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        wait_for(lambda: drv.windows_published >= 1, 60, "w0")
        pack.save_packed(fwx["new"], drv.prefix)
        drv.request_reload()
        wait_for(lambda: drv.reload_errors == 1, 30, "failed reload")
        write_lines(spool, lines[150:300], mode="a")

    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side, fwx["old"])
        write_lines(str(d / "spool.log"), lines[:150])
        runs[side.name] = serve_run(
            side, str(d / "rules"), side.cfg(**RUN_CFG, fault_plan="reload.midbatch@1"),
            side.scfg(**tail_scfg(d, window_lines=150, max_windows=2,
                                  checkpoint_every_windows=0, http="off")), script)
    assert_same_files(runs["ref"], runs["port"])
    assert_same_ring(runs["ref"], runs["port"])
    s = runs["port"].summary
    assert s["reloads"] == 0 and s["reload_errors"] == 1 and s["quarantine_hits"] == 0
    assert "injected fault: reload.midbatch" in runs["port"].drv.last_reload_error
    for i, seg in ((0, lines[:150]), (1, lines[150:300])):
        want = norm(json.loads(REF.run_stream(fwx["rold"], seg, REF.cfg(**RUN_CFG)).to_json()))
        got = norm(runs["port"].files[f"window-{i:06d}.json"])
        for t in (got["totals"], want["totals"]):
            t.pop("window", None)
            t.pop("lineage", None)
        assert got == want


def test_reload_flush_step_failure_aborts_typed(fwx, tmp_path):
    """A device-step failure in the reload's pre-swap flush is a typed
    serve abort, never an atomic reload error (hits 1-2: window 0's chunk
    and its rotation flush; hit 3: the reload flush of window 1's 100
    lines; :99 outlasts the device_put retries)."""
    lines = fwx["lines"]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        wait_for(lambda: drv.windows_published >= 1, 60, "w0")
        write_lines(spool, lines[150:250], mode="a")
        wait_for(lambda: getattr(drv, "win_pushed", 0) >= 100, 30, "w1 in flight")
        pack.save_packed(fwx["new"], drv.prefix)
        drv.request_reload()

    runs = {}
    for side, err in ((REF, RInjectedFault), (PORT, InjectedFault)):
        d = side_dirs(tmp_path, side, fwx["old"])
        write_lines(str(d / "spool.log"), lines[:150])
        runs[side.name] = serve_run(
            side, str(d / "rules"),
            side.cfg(**RUN_CFG, fault_plan="stream.device_put.fail@3:99",
                     retry_policy="device_put=3/0.001"),
            side.scfg(**tail_scfg(d, window_lines=150, checkpoint_every_windows=0,
                                  http="off", max_windows=0)),
            script, expect_error=err)
    for r in runs.values():
        assert r.drv.reload_errors == 0 and r.drv.reloads == 0
    assert_same_files(runs["ref"], runs["port"])


# ---------------------------------------------------------------------------
# Construction errors.
# ---------------------------------------------------------------------------


def test_http_bind_failure_is_typed_construction_error(corpus, tmp_path):
    """An unbindable --http port fails at construction (OSError, the CLI's
    bind error), and releases the listener sockets it had bound."""
    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        port = blocker.getsockname()[1]
        for side in SIDES:
            with pytest.raises(OSError):
                side.driver(corpus["prefix"], side.cfg(**RUN_CFG), side.scfg(
                    listen=("tcp:127.0.0.1:0",), window_lines=100,
                    serve_dir=str(tmp_path / side.name), http=f"127.0.0.1:{port}"))
    finally:
        blocker.close()


def test_serve_missing_ruleset_is_typed(tmp_path, capsys):
    """A bad --ruleset prefix is the typed load error (exit 1), the
    reference's line, never the bind failure."""
    args = ["serve", "--ruleset", str(tmp_path / "nope"), "--listen", "udp:127.0.0.1:0",
            "--window", "lines:100", "--serve-dir", str(tmp_path / "s")]
    got = []
    for main in (cli.main, rcli.main):
        rc = main(list(args))
        err = capsys.readouterr().err.strip().splitlines()
        got.append((rc, err[-1]))
    assert got[0] == got[1]
    assert got[0][0] == 1 and "cannot read packed ruleset" in got[0][1]


def test_serve_driver_refusals_match(corpus, tmp_path):
    """The constructor's own refusals: stacked layout, --coalesce, no
    --listen (the reference's words)."""
    for kw, skw in ((dict(layout="stacked"), {}), (dict(coalesce="on"), {}),
                    ({}, dict(listen=()))):
        msgs = []
        for side in SIDES:
            scfg = side.scfg(**{**dict(listen=("tcp:127.0.0.1:0",), window_lines=10,
                                       serve_dir=str(tmp_path / side.name)), **skw})
            with pytest.raises(Exception) as ei:
                side.driver(corpus["prefix"], side.cfg(**RUN_CFG, **kw), scfg)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# HLL band; diff --expect-window.
# ---------------------------------------------------------------------------


def test_hll_band_and_hint_in_report(corpus):
    got = {}
    for side in SIDES:
        rep = side.run_stream(side_packed(side, corpus), corpus["lines"][:200],
                              side.cfg(**RUN_CFG, sketch=dict(hll_p=10)))
        got[side.name] = (json.loads(rep.to_json())["totals"]["hll"], rep.to_text())
    assert got["port"][0] == got["ref"][0]
    hll = got["port"][0]
    assert hll["p"] == 10 and hll["m"] == 1024 and "--hll-p" in hll["hint"]
    assert "% p90)" in got["port"][1] and "# hint:" in got["port"][1]


def test_diff_expect_window_typed_refusal(tmp_path, capsys):
    def fake_report(mode, length, wid=0):
        return {"totals": {"window": {"mode": mode, "length": length, "id": wid}},
                "per_rule": [], "unused": [], "talkers": {}}

    a, b, c = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "c.json"
    a.write_text(json.dumps(fake_report("lines", 200)))
    c.write_text(json.dumps({"per_rule": [], "unused": [], "totals": {}}))
    cases = []
    for blen, other, flags in ((200, b, ["--expect-window", "lines:200"]),
                               (500, b, ["--expect-window", "lines:200"]),
                               (200, c, ["--expect-window", "lines:200"]),
                               (500, b, [])):
        b.write_text(json.dumps(fake_report("lines", blen, wid=1)))
        rcs = []
        for main in (cli.main, rcli.main):
            rcs.append(main(["diff-reports", str(a), str(other), *flags]))
            rcs.append(capsys.readouterr().out)
        cases.append(rcs)
    assert [c[0] for c in cases] == [0, 1, 1, 0]
    for c in cases:
        assert c[0] == c[2] and c[1] == c[3]


# ---------------------------------------------------------------------------
# The durable ingest WAL: a hard abort mid-window loses nothing consumed.
# ---------------------------------------------------------------------------


def _wal_scfg(d, spool, **kw):
    return tail_scfg(d, spool=spool, window_lines=100, checkpoint_every_windows=1,
                     http="off", max_windows=0, stop_after_sec=60, wal=True, **kw)


def test_wal_resume_after_hard_abort_bit_identical(corpus, tmp_path):
    """device_put fails for good at window 1's first chunk (batch 32): the
    typed abort leaves the spool past the checkpoint; --resume replays it
    and the interrupted window publishes over exactly the delivered lines,
    on each package alike."""
    lines = corpus["lines"][:150]
    runs, delivered = {}, {}
    for side, err in ((REF, RInjectedFault), (PORT, InjectedFault)):
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "a.log"), lines)
        write_lines(str(d / "b.log"), [])
        first = serve_run(side, corpus["prefix"],
                          side.cfg(**{**RUN_CFG, "batch_size": 32},
                                   fault_plan="stream.device_put.fail@5:99",
                                   retry_policy="device_put=3/0.001"),
                          side.scfg(**_wal_scfg(d, "a.log")), expect_error=err)
        assert first.drv.windows_published == 1
        wal = (WriteAheadLog if side is PORT else RWal)(str(d / "serve" / "wal"))
        delivered[side.name] = [line for _s, line, _t in wal.replay(100)]
        wal.close()

        def script(drv, http, n=len(delivered[side.name])):
            wait_for(lambda: drv.wal_replayed == n, 60, "wal replay")

        runs[side.name] = serve_run(side, corpus["prefix"],
                                    side.cfg(**{**RUN_CFG, "batch_size": 32}, resume=True),
                                    side.scfg(**_wal_scfg(d, "b.log")), script)
    assert delivered["port"] == delivered["ref"] == lines[100:100 + len(delivered["port"])]
    assert delivered["port"]
    assert_same_files(runs["ref"], runs["port"])
    assert_same_ring(runs["ref"], runs["port"])
    s = runs["port"].summary
    assert s["wal"]["replayed"] == len(delivered["port"]) and s["wal"]["lost"] == 0
    assert s["windows_published"] == 2 and s["drops"] == 0
    lin = runs["port"].files["lineage.jsonl"]
    # window 0 from the first run, window 1 after the replay, at the stop
    assert [(r["window"], r["path"]) for r in lin] == [(0, "live"), (1, "live")]


def test_wal_eviction_gap_marks_window_incomplete(corpus, tmp_path):
    """A resume whose checkpoint seq predates the surviving WAL head (the
    budget evicted while down) publishes with the wal_lost reason and the
    exact gap, as the reference does."""
    lines = corpus["lines"][:80]
    runs = {}
    for side, err, walcls in ((REF, RInjectedFault, RWal), (PORT, InjectedFault, WriteAheadLog)):
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "a.log"), lines)
        write_lines(str(d / "b.log"), [])
        small = dict(wal_segment_bytes=4096, wal_budget_bytes=8192)
        serve_run(side, corpus["prefix"],
                  side.cfg(**{**RUN_CFG, "batch_size": 32},
                           fault_plan="stream.device_put.fail@1:99",
                           retry_policy="device_put=3/0.001"),
                  side.scfg(**_wal_scfg(d, "a.log", **small)), expect_error=err)
        wal = walcls(str(d / "serve" / "wal"), segment_bytes=4096, budget_bytes=8192)
        consumed = wal.next_seq
        for i in range(400):
            wal.append(f"evict-filler {i} {'x' * 80}")
        assert wal.evicted_records > 0
        wal.close()
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**{**RUN_CFG, "batch_size": 32}, resume=True),
            side.scfg(**_wal_scfg(d, "b.log", **small)),
            lambda drv, http: wait_for(lambda: drv.wal_replayed > 0, 60, "replay"))
        w = runs[side.name].summary["wal"]
        assert w["lost"] > 0 and not w["lost_unknown"]
        assert w["replayed"] + w["lost"] == consumed + 400
    assert_same_files(runs["ref"], runs["port"])
    inc = serve.window_incomplete(runs["port"].files["window-000000.json"])
    assert inc and "wal_lost" in inc["reasons"]


# ---------------------------------------------------------------------------
# Degraded-mode serving: non-core failures degrade, recovery re-arms.
# ---------------------------------------------------------------------------


def test_publisher_degrades_and_recovers(corpus, tmp_path):
    """serve.publish.fail@1:99: window 0 stays in memory only, the reports
    say the publisher was down; after the fault clears the next window's
    writes re-arm it.  Windows come from a lines:N spool, faults from the
    plan, so nothing here waits on load."""
    lines = corpus["lines"][:200]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        port = isinstance(drv, serve.ServeDriver)
        fmod, retry = (faults, retrypolicy) if port else (rfaults, rretry)
        # four writes given up: endpoint.json, then window 0's window,
        # latest and cumulative files; the fault clears after all four
        wait_for(lambda: retry.counters().get("serve.publish", {}).get("giveups", 0) >= 4,
                 60, "window 0's writes")
        out = {"health0": sorted(drv.health()["degraded_subsystems"]),
               "w0": drv.window_report(0),
               "on disk": os.path.exists(os.path.join(drv.scfg.serve_dir,
                                                      "window-000000.json"))}
        fmod.disarm()
        write_lines(spool, lines[100:200], mode="a")
        wait_for(lambda: drv.window_report(1) is not None
                 and "publisher" not in drv.health()["degraded_subsystems"], 60, "recovery")
        return out

    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "spool.log"), lines[:100])
        runs[side.name] = serve_run(
            side, corpus["prefix"],
            side.cfg(**RUN_CFG, fault_plan="serve.publish.fail@1:99",
                     retry_policy="serve.publish=2/0.001"),
            side.scfg(**tail_scfg(d, window_lines=100, checkpoint_every_windows=0,
                                  http="off")), script)
    ref, port = runs["ref"], runs["port"]
    assert_same_files(ref, port)
    assert_same_http(ref, port)
    assert port.http["health0"] == ["publisher"] and port.http["on disk"] is False
    assert port.http["w0"]["totals"]["degraded"] == ["publisher"]
    s = port.summary
    assert s["degraded"] == [] and s["degraded_events"] >= 1 and s["recovered_events"] >= 1
    assert norm(ref.summary) == norm(s)


def test_publisher_transient_retry_recovers_silently(corpus, tmp_path):
    """serve.publish.fail@2:2, inside the attempt bound: the retry absorbs
    the burst, the files land, nothing degrades."""
    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "spool.log"), corpus["lines"][:100])
        runs[side.name] = serve_run(
            side, corpus["prefix"],
            side.cfg(**RUN_CFG, fault_plan="serve.publish.fail@2:2",
                     retry_policy="serve.publish=4/0.001"),
            side.scfg(**tail_scfg(d, window_lines=100, checkpoint_every_windows=0,
                                  http="off", max_windows=1)))
    assert_same_files(runs["ref"], runs["port"])
    s = runs["port"].summary
    assert s["degraded"] == [] and s["retry"]["serve.publish"]["recoveries"] >= 1
    assert "window-000000.json" in runs["port"].files
    assert norm(runs["ref"].summary) == norm(s)


def test_degraded_static_and_metrics_recover(corpus, tmp_path):
    """analyze.tile and metrics.snapshot.fail degrade the static and metrics
    planes while ingest serves; a reload's re-analysis and a clean tick
    re-arm both, and no partial verdict table is ever served."""
    lines = corpus["lines"][:100]

    def script(drv, http):
        port = isinstance(drv, serve.ServeDriver)
        wait_for(lambda: drv.window_report(0) is not None, 60, "window 0")
        wait_for(lambda: {"static_analysis", "metrics"}
                 <= set(drv.health()["degraded_subsystems"]), 30, "degraded set")
        out = {"status": drv.health()["status"],
               "w0 degraded": drv.window_report(0)["totals"]["degraded"],
               "static before": drv.published("static")}
        (faults if port else rfaults).disarm()
        drv.request_reload()
        wait_for(lambda: not drv.health()["degraded_subsystems"], 60, "recovery")
        out["static after"] = drv.published("static")
        return out

    runs = {}
    for side in SIDES:
        d = side_dirs(tmp_path, side)
        write_lines(str(d / "spool.log"), lines)
        mobs = obs if side is PORT else robs
        runs[side.name] = serve_run(
            side, corpus["prefix"],
            side.cfg(**RUN_CFG, fault_plan="analyze.tile@1,metrics.snapshot.fail@1:99"),
            side.scfg(**tail_scfg(d, window_lines=100, checkpoint_every_windows=0,
                                  http="off", static_analysis=True)),
            script, before=lambda s, m=mobs, p=str(d / "m.jsonl"): m.start_metrics(p, 0.05))
    ref, port = runs["ref"], runs["port"]
    assert port.http["status"] == "degraded"
    assert set(port.http["w0 degraded"]) >= {"static_analysis"}
    assert port.http["static before"] is None
    assert norm(port.http["static after"]) == norm(ref.http["static after"])
    s = port.summary
    assert s["degraded"] == [] and s["degraded_events"] >= 2 and s["recovered_events"] >= 2
    assert norm(ref.summary)["windows_published"] == s["windows_published"]
