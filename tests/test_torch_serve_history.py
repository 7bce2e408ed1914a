"""Serve with the durable epoch store, in the port against the reference.

Each case runs both packages' ``ServeDriver`` with ``epoch_store`` set over
the same ``tail0:`` spool and scenario (``tests/_torch_servekit.py``) and
holds what they publish equal, apart from ``VOLATILE_TOTALS``,
``totals.backend`` and the wall stamps: the window files and
``summary.json`` (its ``epoch_store`` block but the store's path and byte
size, whose level-0 nodes carry the windows' wall stamps); the
``/report/range`` bodies, the typed 404 of a ``range_incomplete`` answer
and the 400 of a bad bound; ``/report/last-hit`` (the hits' wall stamps
apart); ``/lineage`` with the store's frontier; the ``epochstore_*``
gauges and the Prometheus names.  With the static analysis on, every
report's ``safe_to_delete`` verdicts carry the store's last-hit horizon.

Then a reload that migrates the key space marks an era: a range reaching
across it is refused as ``keyspace_migration``, one inside it answers;
and ``epochstore.spill@1`` degrades the ``epoch_store`` subsystem while
publication goes on.
"""

import re

import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu_torch.hostside import pack  # noqa: E402
from tests._torch_servekit import (  # noqa: E402
    PORT, SIDES, assert_same_ring, get_json, get_text, http_code, norm, serve_run,
    wait_for, write_lines,
)
from tests.test_serve import NEW_CFG, OLD_CFG, _fwx_lines  # noqa: E402

RUN_CFG = dict(batch_size=128, prefetch_depth=0)
WL = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fwx():
    """The reference's reload corpus: OLD_CFG, its renumbered NEW_CFG (an
    insert and a delete), and 600 lines against both."""
    return {"old": PORT.packed(OLD_CFG, "fwx"), "new": PORT.packed(NEW_CFG, "fwx"),
            "lines": _fwx_lines(600, seed=7)}


def _strip_history(obj) -> None:
    if isinstance(obj, dict):
        # the wall stamps of a last hit
        obj.pop("unix", None)
        obj.pop("last_hit_unix", None)
        es = obj.get("epoch_store")
        if isinstance(es, dict):
            es.pop("dir", None)
            es.pop("bytes", None)
        for v in obj.values():
            _strip_history(v)
    elif isinstance(obj, list):
        for v in obj:
            _strip_history(v)


def hnorm(obj):
    """:func:`norm`, and without the store's path, size and wall stamps."""
    obj = norm(obj)
    _strip_history(obj)
    return obj


def store_gauges(m: dict) -> dict:
    """The store's gauges of a /metrics body, its byte size apart."""
    return {k: v for k, v in m.items()
            if k.startswith("epochstore_") and k != "epochstore_bytes"}


def prom_names(text: str) -> set:
    return {m.group(1) for m in re.finditer(r"^([a-z_]+)[{ ]", text, re.M)}


def run_both(tmp_path, fwx, lines, script, **scfg_kw):
    """One serve run of each package over ``lines`` in a ``tail0:`` spool,
    with the epoch store in the side's own directory (``cfg=`` adds to the
    AnalysisConfig fields)."""
    runs = {}
    cfg_kw = dict(RUN_CFG, **scfg_kw.pop("cfg", {}))
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        prefix = str(d / "rules")
        pack.save_packed(fwx["old"], prefix)
        write_lines(str(d / "spool.log"), lines)
        scfg = dict(listen=(f"tail0:{d / 'spool.log'}",), window_lines=WL, ring=2,
                    serve_dir=str(d / "serve"), stop_after_sec=90, reload_watch=False,
                    queue_lines=10_000, checkpoint_every_windows=0,
                    epoch_store=str(d / "estore"), http="127.0.0.1:0")
        scfg.update(scfg_kw)
        runs[side.name] = serve_run(side, prefix, side.cfg(**cfg_kw), side.scfg(**scfg), script)
    return runs["ref"], runs["port"]


def assert_same(ref, port) -> None:
    assert set(ref.files) == set(port.files)
    for name in sorted(ref.files):
        assert hnorm(ref.files[name]) == hnorm(port.files[name]), f"{name} differs"
    assert set(ref.http) == set(port.http)
    for key in sorted(ref.http):
        assert hnorm(ref.http[key]) == hnorm(port.http[key]), f"HTTP {key} differs"
    assert hnorm(ref.summary) == hnorm(port.summary)


def test_serve_epoch_store_bodies_match_the_reference(fwx, tmp_path):
    """Four windows through a ring of two, the static analysis on: every
    range, last-hit, lineage and metrics body and every file is the
    reference's."""
    lines = fwx["lines"]

    def script(drv, http):
        wait_for(lambda: drv.windows_published >= 4, 60, "four windows")
        bodies = {
            "range 0-3": get_json(http, "/report/range?from=0&to=3"),
            "range 1-2": get_json(http, "/report/range?from=1&to=2"),
            "range 3": get_json(http, "/report/range?from=3&to=3"),
            "range default": get_json(http, "/report/range"),
            "code future": http_code(http, "/report/range?from=0&to=9"),
            "code reversed": http_code(http, "/report/range?from=3&to=1"),
            "code bad bound": http_code(http, "/report/range?from=x"),
            "last-hit": get_json(http, "/report/last-hit"),
            "lineage": get_json(http, "/lineage"),
            "cumulative": get_json(http, "/report/cumulative"),
            "window 3": get_json(http, "/report/window/3"),
        }
        bodies["store gauges"] = store_gauges(get_json(http, "/metrics"))
        bodies["prom names"] = sorted(
            n for n in prom_names(get_text(http, "/metrics?format=prom"))
            if "epochstore" in n or "range_query" in n)
        return bodies

    ref, port = run_both(tmp_path, fwx, lines, script, static_analysis=True)
    assert_same(ref, port)
    assert_same_ring(ref, port)
    b = port.http
    # the reference's own expectations, on the port
    assert b["range 0-3"]["per_rule"] == b["cumulative"]["per_rule"]
    win = b["range 0-3"]["totals"]["window"]
    assert win["range"] == [0, 3] and win["windows"] == 4 and win["length"] == WL
    assert b["range 3"]["per_rule"] == b["window 3"]["per_rule"]
    assert b["range default"]["totals"]["window"]["range"] == [0, 3]
    code, marker = b["code future"]
    assert code == 404 and marker == {"range_incomplete": True, "from": 0, "to": 9,
                                      "reason": "beyond_frontier", "window": 4}
    assert b["code reversed"][0] == 404 and b["code reversed"][1]["reason"] == "empty_range"
    assert b["code bad bound"] == (400, {"error": "bad range bound 'x'"})
    assert b["last-hit"]["frontier"] == 3 and b["last-hit"]["rules"]
    assert b["lineage"]["epoch_store"]["last_spilled_window"] == 3
    static = b["range 0-3"]["totals"]["static"]
    assert static["last_hit"]["horizon_window"] == 3
    g = b["store gauges"]
    assert g["epochstore_spilled_total"] == 4 and g["epochstore_levels"] == 3
    assert g["epochstore_range_queries_total"] == 6  # a bad bound never reaches the store
    assert g["epochstore_range_incomplete_total"] == 2
    assert "ra_serve_range_query_seconds_count" in b["prom names"]
    assert port.summary["epoch_store"]["epochs"] == 4
    assert port.summary["epoch_store"]["compactions_total"] == 3


def test_serve_reload_marks_an_era_the_range_refuses(fwx, tmp_path):
    """A reload to the renumbered ruleset inside window 1: ranges reaching
    before window 1 are refused as keyspace_migration, ranges inside the new
    era answer, and the summary nodes straddling the boundary are holes."""
    lines = fwx["lines"]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        wait_for(lambda: drv.health()["current_window"] == {"id": 1, "pushed": 75},
                 60, "w0 + half of w1")
        pack.save_packed(fwx["new"], drv.prefix)
        drv.request_reload()
        wait_for(lambda: drv.health()["reloads"] == 1, 30, "reload")
        write_lines(spool, lines[WL + 75:4 * WL], mode="a")
        wait_for(lambda: drv.windows_published >= 4, 60, "four windows")
        return {
            "code across": http_code(http, "/report/range?from=0&to=3"),
            "code before": http_code(http, "/report/range?from=0&to=0"),
            "range 1-3": get_json(http, "/report/range?from=1&to=3"),
            "range 2-3": get_json(http, "/report/range?from=2&to=3"),
            "last-hit": get_json(http, "/report/last-hit"),
            "store gauges": store_gauges(get_json(http, "/metrics")),
        }

    ref, port = run_both(tmp_path, fwx, lines[:WL + 75], script)
    assert_same(ref, port)
    b = port.http
    for key in ("code across", "code before"):
        code, marker = b[key]
        assert code == 404 and marker["reason"] == "keyspace_migration" and marker["window"] == 0
    assert b["range 1-3"]["totals"]["window"]["range"] == [1, 3]
    assert b["range 1-3"]["totals"]["quarantine"]["hits"] > 0
    s = port.summary["epoch_store"]
    assert s["eras"] == 1 and s["holes_total"] >= 1 and port.summary["reloads"] == 1


def test_serve_spill_fault_degrades_the_store_only(fwx, tmp_path):
    """``epochstore.spill@1``: the first spill fails before any byte lands,
    the epoch_store subsystem degrades and stays off, every window still
    publishes, and the empty store answers typed."""
    lines = fwx["lines"][:3 * WL]

    def script(drv, http):
        wait_for(lambda: drv.windows_published >= 3, 60, "three windows")
        h = get_json(http, "/health")
        return {
            "health": {k: h[k] for k in ("status", "degraded_subsystems", "degraded_events",
                                         "windows_published")},
            "degraded error": h["degraded_errors"]["epoch_store"],
            "code range": http_code(http, "/report/range?from=0&to=0"),
            "last-hit": get_json(http, "/report/last-hit"),
            "lineage": get_json(http, "/lineage"),
            "store gauges": store_gauges(get_json(http, "/metrics")),
        }

    ref, port = run_both(tmp_path, fwx, lines, script,
                         cfg={"fault_plan": "epochstore.spill@1"})
    assert_same(ref, port)
    b = port.http
    assert b["health"]["degraded_subsystems"] == ["epoch_store"]
    assert b["health"]["windows_published"] == 3
    assert "epochstore.spill" in b["degraded error"]
    assert b["code range"] == (404, {"range_incomplete": True, "from": 0, "to": 0,
                                     "reason": "empty_store"})
    assert b["last-hit"]["frontier"] is None
    assert b["lineage"]["epoch_store"]["last_spilled_window"] is None
    assert port.summary["degraded"] == ["epoch_store"]
    assert port.summary["epoch_store"]["epochs"] == 0
    assert port.files["summary.json"]["windows_published"] == 3
    assert port.files["window-000002.json"]["totals"]["degraded"] == ["epoch_store"]
