"""Shared harness of the port's serve parity tests (test_torch_serve,
test_torch_serve_planes, test_torch_serve_cli).

A :class:`ServeSide` bundles one package's serve modules and config
classes, so a test drives the reference's ``ServeDriver`` (on a
one-device mesh) and the port's (on the CPU, the kernels' plain versions)
through the same code.  :func:`serve_run` starts one driver on a thread,
runs a scenario script against it (spool appends, reload requests, HTTP
reads) and collects what it published: the files of its serve dir, the
lineage ledger, the HTTP bodies the script read and the ring's
registers.  The two sides run one after the other, each with every fault,
trace and recorder plane of both packages disarmed before it starts
(``_torch_faultkit.reset_all``).

Comparisons strip what is volatile by nature: ``VOLATILE_TOTALS`` and
``totals.backend`` of every report, the window's wall and monotonic
stamps (``started_unix``, ``ended_unix``, ``elapsed_sec``), the lineage
records' ``LINEAGE_VOLATILE`` keys (``published_unix`` and the ``crc``
over the core; the core is compared whole), the static analysis's
``duration_sec``, and the summary's ``serve_dir``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np

from ruleset_analysis_tpu import config as rconfig
from ruleset_analysis_tpu.hostside import aclparse as raclparse
from ruleset_analysis_tpu.hostside import pack as rpack
from ruleset_analysis_tpu.parallel import mesh as rmesh
from ruleset_analysis_tpu.runtime import checkpoint as rckpt
from ruleset_analysis_tpu.runtime import serve as rserve
from ruleset_analysis_tpu.runtime import stream as rstream
from ruleset_analysis_tpu.runtime.report import LINEAGE_VOLATILE, VOLATILE_TOTALS
from ruleset_analysis_tpu_torch import config
from ruleset_analysis_tpu_torch.hostside import aclparse, pack
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt
from ruleset_analysis_tpu_torch.runtime import serve, stream
from tests._torch_faultkit import reset_all

#: the window stamps of a serve report: wall and monotonic clocks
WINDOW_STAMPS = ("started_unix", "ended_unix", "elapsed_sec")

#: serve-dir files that name the process, not the analysis
UNCOMPARED_FILES = {"endpoint.json"}


class ServeSide:
    """One package's serve: driver, configs, packing, offline runs."""

    def __init__(self, name: str):
        self.name = name
        port = name == "port"
        self.serve = serve if port else rserve
        self.stream = stream if port else rstream
        self.ckpt = ckpt if port else rckpt
        self.pack = pack if port else rpack
        self.aclparse = aclparse if port else raclparse
        self.config = config if port else rconfig

    def cfg(self, **kw):
        if "sketch" in kw and isinstance(kw["sketch"], dict):
            kw["sketch"] = self.config.SketchConfig(**kw["sketch"])
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.config.AnalysisConfig(**kw)

    def scfg(self, **kw):
        return self.config.ServeConfig(**kw)

    def driver(self, prefix: str, cfg, scfg, **kw):
        if self.name == "ref":
            kw.setdefault("mesh", rmesh.make_mesh(jax.devices()[:1]))
        return self.serve.ServeDriver(prefix, cfg, scfg, **kw)

    def packed(self, cfg_text: str, firewall: str):
        return self.pack.pack_rulesets([self.aclparse.parse_asa_config(cfg_text, firewall)])

    def run_stream(self, packed, lines, cfg, **kw):
        if self.name == "ref":
            kw.setdefault("mesh", rmesh.make_mesh(jax.devices()[:1]))
        return self.stream.run_stream(packed, iter(lines), cfg, **kw)

    def run_stream_wire(self, packed, path, cfg, **kw):
        if self.name == "ref":
            kw.setdefault("mesh", rmesh.make_mesh(jax.devices()[:1]))
        return self.stream.run_stream_wire(packed, path, cfg, **kw)


PORT, REF = ServeSide("port"), ServeSide("ref")
SIDES = (REF, PORT)


def write_lines(path: str, lines: list[str], mode: str = "w") -> None:
    with open(path, mode, encoding="utf-8") as f:
        f.write("".join(line + "\n" for line in lines))


def wait_for(pred, timeout: float = 60, msg: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def get_json(http, path: str, retries: int = 3):
    host, port = http
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=10) as r:
                return json.load(r)
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, ConnectionError, OSError):
            if attempt == retries - 1:
                raise
            time.sleep(0.2)


def get_text(http, path: str) -> str:
    host, port = http
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=10) as r:
        return r.read().decode()


def http_code(http, path: str) -> tuple[int, dict]:
    """(status, JSON body) of one GET, error statuses included."""
    try:
        return 200, get_json(http, path, retries=1)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def start(drv):
    """Run ``drv`` on a thread; returns (thread, outcome dict) once its
    listeners (and HTTP endpoint, when bound) are up, or it failed."""
    out: dict = {}

    def runner():
        try:
            out["summary"] = drv.run()
        except BaseException as e:  # surfaced by finish()
            out["error"] = e

    th = threading.Thread(target=runner)
    th.start()
    wait_for(lambda: "error" in out or "summary" in out or (
        drv.listeners.listeners and drv.listeners.alive()
        and (drv.scfg.http == "off" or drv.http_address)
    ), 60, "serve start")
    return th, out


class Run:
    """What one serve run published."""

    def __init__(self, drv, summary, error, files: dict, http: dict):
        self.drv = drv
        self.summary = summary
        self.error = error
        self.files = files
        self.http = http
        self.ring = [(dict(ep.meta), {k: np.asarray(v) for k, v in ep.arrays.items()},
                      ep.tracker_tables, dict(ep.quarantine))
                     for ep in drv.ring.epochs]


def read_serve_dir(serve_dir: str) -> dict:
    out = {}
    if not os.path.isdir(serve_dir):
        return out
    for name in sorted(os.listdir(serve_dir)):
        p = os.path.join(serve_dir, name)
        if name.endswith(".json") and name not in UNCOMPARED_FILES:
            with open(p, encoding="utf-8") as f:
                out[name] = json.load(f)
        elif name == "lineage.jsonl":
            with open(p, encoding="utf-8") as f:
                out[name] = [json.loads(line) for line in f if line.strip()]
    return out


def serve_run(side: ServeSide, prefix: str, cfg, scfg, script=None, *,
              expect_error: type | tuple | None = None, before=None, **drv_kw) -> Run:
    """One driver of ``side`` over ``scfg``: start it, run ``script(drv,
    http)`` (which returns the HTTP bodies it read, or None), stop it
    unless it stops itself (``max_windows``) or is to abort with
    ``expect_error``, and collect what it published.
    ``before(side)`` runs once the planes are reset, before the ServeDriver
    is built (to start a metrics plane, say)."""
    reset_all()
    if before is not None:
        before(side)
    drv = side.driver(prefix, cfg, scfg, **drv_kw)
    th, out = start(drv)
    bodies = {}
    try:
        if script is not None and "error" not in out:
            bodies = script(drv, drv.http_address) or {}
    finally:
        # a run that stops itself (max_windows) or is to abort runs to its end
        if not scfg.max_windows and expect_error is None:
            drv.stop()
        th.join(timeout=120)
    assert not th.is_alive(), f"{side.name}: serve hung"
    error = out.get("error")
    if expect_error is None and error is not None:
        raise error
    if expect_error is not None:
        assert isinstance(error, expect_error), f"{side.name}: {error!r}"
    reset_all()
    return Run(drv, out.get("summary"), error, read_serve_dir(scfg.serve_dir), bodies)


def _drop_durations(obj) -> None:
    if isinstance(obj, dict):
        obj.pop("duration_sec", None)
        for v in obj.values():
            _drop_durations(v)
    elif isinstance(obj, list):
        for v in obj:
            _drop_durations(v)


def norm(obj):
    """A published object without what is volatile by nature."""
    obj = json.loads(json.dumps(obj))
    _drop_durations(obj)
    if isinstance(obj, list):  # a lineage ledger, or an HTTP (status, body) pair
        return [norm(x) for x in obj]
    if not isinstance(obj, dict):
        return obj
    t = obj.get("totals")
    if isinstance(t, dict):
        for k in VOLATILE_TOTALS + ("backend",):
            t.pop(k, None)
        w = t.get("window")
        if isinstance(w, dict):
            for k in WINDOW_STAMPS:
                w.pop(k, None)
        if isinstance(t.get("lineage"), dict):
            t["lineage"] = norm_lineage(t["lineage"])
    if "records" in obj and "records_total" in obj:  # the /lineage view
        obj["records"] = [norm_lineage(r) for r in obj["records"]]
        obj["merged"] = [norm_lineage(r) for r in obj["merged"]]
    if "kind" in obj and "window" in obj and "crc" in obj:
        obj = norm_lineage(obj)
    obj.pop("serve_dir", None)
    return obj


def norm_lineage(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in LINEAGE_VOLATILE}


def assert_same_files(a: Run, b: Run) -> None:
    """Equal serve-dir files (the same names, each the same after
    :func:`norm`)."""
    names = set(a.files)
    assert names == set(b.files), (sorted(a.files), sorted(b.files))
    for name in sorted(names):
        assert norm(a.files[name]) == norm(b.files[name]), f"{name} differs"


def assert_same_ring(a: Run, b: Run) -> None:
    """Equal ring epochs: registers bit for bit, meta, talkers, quarantine."""
    assert len(a.ring) == len(b.ring)
    for (ma, ra, ta, qa), (mb, rb, tb, qb) in zip(a.ring, b.ring):
        assert {k: v for k, v in ma.items() if k not in WINDOW_STAMPS} == \
            {k: v for k, v in mb.items() if k not in WINDOW_STAMPS}
        assert set(ra) == set(rb)
        for k in ra:
            assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k]), \
                f"window {ma['id']} register {k}"
        assert ta == tb and qa == qb


def assert_same_http(a: Run, b: Run) -> None:
    assert set(a.http) == set(b.http)
    for path in sorted(a.http):
        assert norm(a.http[path]) == norm(b.http[path]), f"HTTP {path} differs"


def registers_of(side: ServeSide, packed, lines, cfg_kw: dict, ck_dir: str) -> dict:
    """The final registers of ``side``'s offline ``run_stream`` over
    ``lines``, through the checkpoint plane."""
    cfg = side.cfg(**{**cfg_kw, "checkpoint_every_chunks": 10_000, "checkpoint_dir": ck_dir})
    side.run_stream(packed, lines, cfg)
    snap = side.ckpt.load(ck_dir)
    assert snap is not None
    return snap.arrays
