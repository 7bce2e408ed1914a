"""The port's elastic tier (runtime/elastic.py) against the reference's, in
one process on the CPU.

- the shard re-split (``assign_shards``) and the epoch manifest
  (``manifest_of``): each package's ``checkpoint.load`` reads the other's
  epoch snapshot to the same ``(shards, cursors, done)``;
- the supervisor's refusals, its formation (one member, a stale member
  left out, a finished previous generation) and its report patch;
- ``_ShardCursorSource``: batches and ``cursor_rows()`` after every batch
  equal the reference's, over the native and the Python parse, with
  non-zero start cursors, v4 and dual-stack; under ``PrefetchingSource``
  at depth 2 only the consumed batches' cursors show, in both packages;
- the ``-elastic`` fingerprint is the reference's;
- a one-process gloo elastic tier stopped with ``max_chunks`` and resumed
  from its epoch through a new ``ElasticRunSpec`` gives the uninterrupted
  run's registers, and its epoch snapshot loads in the reference;
- ``AnalysisConfig.to_dict`` / ``from_dict``, exit code 7, every CLI
  refusal against the reference CLI's exit code and message, and the
  flight recorder's supervisor and worker shards.

The multi-process drills are in tests/test_torch_elastic_procs.py.
Tolerance 0 throughout.
"""

import dataclasses
import json
import os
import socket
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu import errors as rerrors  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import elastic as relastic  # noqa: E402
from ruleset_analysis_tpu.runtime import ingest as ringest  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu_torch import cli, errors  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import distributed as dist  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import elastic  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.ingest import PrefetchingSource  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import (  # noqa: E402
    _ShardCursorSource, run_stream_file, run_stream_file_distributed,
)
from tests._torch_faultkit import CFG6, mixed_lines, reset_all  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")
SKETCH = dict(cms_width=1 << 10, cms_depth=4, hll_p=6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_shards(td, lines, sizes) -> list[str]:
    paths, pos = [], 0
    for i, n in enumerate(sizes):
        p = td / f"shard{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[pos:pos + n]), encoding="utf-8")
        paths.append(str(p))
        pos += n
    return paths


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """v4: the reference elastic test's 1600 lines over 3 ACLs (egress bound)
    in 4 shards of 400; dual: 1200 mixed v4 + v6 lines in 4 uneven shards,
    one of them empty."""
    out = {}
    td = tmp_path_factory.mktemp("elastic_v4")
    rs = aclparse.parse_asa_config(
        synth.synth_config(n_acls=3, rules_per_acl=8, seed=41, egress_acls=True), "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 1600, seed=42), seed=43,
                                variety=0.4)
    pack.save_packed(packed, str(td / "packed"))
    out["v4"] = (td, packed, rpack.load_packed(str(td / "packed")),
                 _write_shards(td, lines, (400, 400, 400, 400)))
    td = tmp_path_factory.mktemp("elastic_dual")
    packed = pack.pack_rulesets([aclparse.parse_asa_config(CFG6, "fw1")])
    pack.save_packed(packed, str(td / "packed"))
    out["dual"] = (td, packed, rpack.pack_rulesets([raclparse.parse_asa_config(CFG6, "fw1")]),
                   _write_shards(td, mixed_lines(1200, seed=5), (500, 300, 0, 400)))
    return out


# ---------------------------------------------------------------------------
# assign_shards and manifest_of
# ---------------------------------------------------------------------------


def test_assign_shards_round_robin_complete():
    shards = [f"s{i}" for i in range(5)]
    out = elastic.assign_shards(shards, {1: 100}, {0}, 3)
    # every remaining shard assigned exactly once, cursors kept
    assert out == [[(1, "s1", 100), (4, "s4", 0)], [(2, "s2", 0)], [(3, "s3", 0)]]
    # a smaller world re-splits the same remaining work
    out2 = elastic.assign_shards(shards, {1: 100}, {0}, 2)
    assert sorted(x for part in out2 for x in part) == [
        (1, "s1", 100), (2, "s2", 0), (3, "s3", 0), (4, "s4", 0)]


def test_assign_shards_more_ranks_than_shards():
    assert elastic.assign_shards(["a", "b"], {}, set(), 4) == [[(0, "a", 0)], [(1, "b", 0)],
                                                                [], []]


@pytest.mark.parametrize("n, cursors, done, world", [
    (4, {}, set(), 1),
    (4, {0: 7, 3: 2**33 + 5}, {1}, 3),
    (7, {2: 1, 5: 9}, {0, 6}, 2),
    (3, {0: 4}, {0, 1, 2}, 2),
    (1, {}, set(), 4),
    (9, {i: i * 11 for i in range(9)}, {4}, 4),
])
def test_assign_shards_is_the_references(n, cursors, done, world):
    shards = [f"/logs/s{i}.log" for i in range(n)]
    got = elastic.assign_shards(shards, cursors, done, world)
    assert got == relastic.assign_shards(shards, cursors, set(done), world)
    assert sorted(i for part in got for i, _p, _c in part) == [
        i for i in range(n) if i not in done]


MANIFESTS = [
    {"epoch": 2, "world": 3, "shards": ["/logs/a.log", "/logs/b.log", "/logs/c.log"],
     "cursors": {"0": 400, "1": 2**33 + 7, "2": 0}, "done": [0]},
    {"epoch": 0, "world": 1, "shards": ["x"], "cursors": {}, "done": []},
]


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("manifest", MANIFESTS, ids=["three", "empty"])
def test_epoch_manifest_reads_the_same_in_both_packages(tmp_path, writer, manifest):
    mods = {"port": ckpt, "ref": rckpt}
    snap = mods[writer].Snapshot(
        arrays={"a": np.arange(8, dtype=np.uint32)}, lines_consumed=400, n_chunks=6,
        parsed=400, skipped=0, tracker_tables={1: {10: 5}}, fingerprint="fp-elastic",
        extra={"elastic": manifest, "v6_digests": [[3, 2**100 + 1]]},
    )
    mods[writer].save(str(tmp_path), snap)
    want = (manifest["shards"], {int(k): v for k, v in manifest["cursors"].items()},
            set(manifest["done"]))
    for reader, man_of in ((ckpt, elastic.manifest_of), (rckpt, relastic.manifest_of)):
        got = reader.load(str(tmp_path))
        assert got.extra["elastic"] == manifest
        assert man_of(got) == want


@pytest.mark.parametrize("extra", [None, {"v6_digests": [[1, 2]]}])
def test_manifest_of_a_snapshot_without_one_is_empty(extra):
    snap = ckpt.Snapshot(arrays={}, lines_consumed=0, n_chunks=0, parsed=0, skipped=0,
                         tracker_tables={}, fingerprint="fp", extra=extra)
    assert elastic.manifest_of(snap) == relastic.manifest_of(snap) == (None, {}, set())
    assert elastic.manifest_of(None) == (None, {}, set())


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------


def _sides(tmp_path, case):
    """(cfg, shards) of a refusal case for each package's supervisor."""
    log = tmp_path / "a.log"
    log.write_text("x\n")
    w = tmp_path / "a.rawire"
    w.write_bytes(wire.MAGIC + b"\0" * 64)
    every = 0 if case == "cadence" else 2
    shards = [str(w)] if case == "wire" else [str(log)]
    return every, shards


@pytest.mark.parametrize("case, match", [("cadence", "checkpoint"), ("wire", "rawire"),
                                         ("tag", "outside")])
def test_supervisor_refusals_are_the_references(tmp_path, case, match):
    every, shards = _sides(tmp_path, case)
    tag = 2 if case == "tag" else 0
    msgs = []
    for sup, err, cfg in ((elastic.ElasticSupervisor, errors.AnalysisError,
                           AnalysisConfig(checkpoint_every_chunks=every)),
                          (relastic.ElasticSupervisor, rerrors.AnalysisError,
                           JConfig(checkpoint_every_chunks=every))):
        with pytest.raises(err, match=match) as ei:
            sup(str(tmp_path / "d"), tag, 2, "rs", shards, cfg)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert not os.path.exists(tmp_path / "d")


def _supervisor(tmp_path, tag=0, n=1, **kw):
    log = tmp_path / "a.log"
    log.write_text("x\n")
    return elastic.ElasticSupervisor(str(tmp_path / "el"), tag, n, str(tmp_path / "rs"),
                                     [str(log)], AnalysisConfig(checkpoint_every_chunks=2,
                                                                resume=True), **kw)


def test_supervisor_job_hands_the_config_to_its_workers(tmp_path):
    sup = _supervisor(tmp_path, max_reforms=3, topk=7, native=False, fault={"tag": "0"})
    job = json.loads(json.dumps(sup.job))
    cfg = AnalysisConfig.from_dict(job["cfg"])
    # workers start from the epoch dir, never from a per-process resume
    assert cfg == sup.cfg and not cfg.resume
    assert (job["topk"], job["native"], job["fault"]) == (7, False, {"tag": "0"})
    # torch's one timeout bounds the formation and every collective: the
    # reference's formation bound, not its 10 s heartbeat
    assert job["init_timeout"] == elastic.INIT_TIMEOUT_SEC == relastic.JAX_INIT_TIMEOUT_SEC
    # the reference's keys but its jax heartbeat; no autoscale without the flag
    assert job["autoscale"] is None
    assert set(job) == {k for k in relastic.ElasticSupervisor(
        str(tmp_path / "el2"), 0, 1, "rs", [str(tmp_path / "a.log")],
        JConfig(checkpoint_every_chunks=2)).job if k != "heartbeat_timeout"}


@pytest.mark.parametrize("side", ["port", "ref"])
def test_one_member_forms_alone_and_leads(tmp_path, side):
    if side == "port":
        sup = _supervisor(tmp_path, coordinator_host="127.0.0.9")
    else:
        (tmp_path / "a.log").write_text("x\n")
        sup = relastic.ElasticSupervisor(str(tmp_path / "el"), 0, 1, "rs",
                                         [str(tmp_path / "a.log")],
                                         JConfig(checkpoint_every_chunks=2),
                                         coordinator_host="127.0.0.9")
    os.makedirs(os.path.join(sup.dir, "members"))
    plan = sup._form(0)
    assert plan["gen"] == 0 and plan["world"] == [0]
    assert plan["coordinator"].startswith("127.0.0.9:")
    assert int(plan["coordinator"].rsplit(":", 1)[1]) > 0
    assert os.listdir(os.path.join(sup.dir, "gen-0", "join")) == ["0"]
    assert [f for f in os.listdir(os.path.join(sup.dir, "gen-0")) if f.endswith(".tmp")] == []


def test_a_stale_member_is_left_out_of_the_next_generation(tmp_path):
    sup = _supervisor(tmp_path, tag=1, n=3)
    members = os.path.join(sup.dir, "members")
    os.makedirs(members)
    now = time.time()
    for tag, age in ((0, elastic.STALE_SEC + 5), (1, 0.0), (2, 0.0)):
        p = os.path.join(members, f"{tag}.hb")
        open(p, "w").close()
        os.utime(p, (now - age, now - age))
    assert sup._fresh_members() == {1, 2}
    # member 2 joined already; 0 is stale, so 1 is the lowest survivor and leads
    os.makedirs(os.path.join(sup.dir, "gen-1", "join"))
    open(os.path.join(sup.dir, "gen-1", "join", "2"), "w").close()
    plan = sup._form(1)
    assert plan["world"] == [1, 2]


def test_a_member_outside_the_plan_aborts(tmp_path):
    sup = _supervisor(tmp_path, tag=1, n=2)
    os.makedirs(os.path.join(sup.dir, "gen-1"))
    elastic._atomic_write_json(sup._plan_path(1), {"gen": 1, "world": [0],
                                                   "coordinator": "h:1"})
    with pytest.raises(errors.AnalysisError, match="missed generation 1 formation"):
        sup._form(1)


def test_a_finished_previous_generation_ends_the_formation(tmp_path):
    sup = _supervisor(tmp_path, n=2)
    sup._marker(0, "done")
    with pytest.raises(elastic._PrevGenDone):
        sup._form(1)


def test_peer_failure_markers_name_only_other_members(tmp_path):
    sup = _supervisor(tmp_path, n=2)
    sup._marker(3, "failed")
    assert not sup._peer_failed(3)
    open(os.path.join(sup._gen_dir(3), "failed", "1"), "w").close()
    assert sup._peer_failed(3)


def test_patch_result_adds_the_recovery_totals(tmp_path):
    sup = _supervisor(tmp_path)
    os.makedirs(sup.dir)
    path = os.path.join(sup.dir, "result.json")
    elastic._atomic_write_json(path, {"totals": {"lines_total": 5}, "per_rule": []})
    sup.reforms_used = 1
    sup.meter.detect("peer worker failed")
    sup.meter.recovered(world=3)
    assert sup._patch_result(path) == path
    with open(path, encoding="utf-8") as f:
        rec = json.load(f)["totals"]["recovery"]
    assert rec["reforms_used"] == 1 and rec["recovery_events"] == 1
    assert rec["recoveries"][0]["world"] == 3
    assert os.listdir(sup.dir) == ["result.json"]  # no temp file left
    # a missing report stands as it is
    assert sup._patch_result(os.path.join(sup.dir, "none.json")).endswith("none.json")


def test_worker_entry_refuses_bad_arguments():
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-m", "ruleset_analysis_tpu_torch.runtime.elastic"],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode == 2 and "usage:" in p.stderr


# ---------------------------------------------------------------------------
# The shard-cursor source
# ---------------------------------------------------------------------------


def _assignments(shards):
    n = [sum(1 for _ in open(p)) for p in shards]
    return [(0, shards[0], min(17, n[0])), (2, shards[2], 0), (3, shards[3], n[3] // 2),
            (1, shards[1], max(0, n[1] - 5))]


def _rows6(rows) -> np.ndarray:
    a = np.asarray(rows, dtype=np.uint32)
    return a.reshape(a.shape[0], -1) if a.size else a.reshape(0)


@pytest.mark.parametrize("kind", ["v4", "dual"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("batch", [64, 100])
def test_cursor_rows_after_every_batch_are_the_references(corpora, kind, native, batch):
    _td, packed, rpacked, shards = corpora[kind]
    if native:
        ensure_reference_native()
    asg = _assignments(shards)
    mine = _ShardCursorSource(packed, asg, native)
    ref = rstream._ShardCursorSource(rpacked, asg, native)
    np.testing.assert_array_equal(mine.cursor_rows(), ref.cursor_rows())
    n = 0
    for (b, n_raw), (rb, rn) in zip(mine.batches(0, batch), ref.batches(0, batch),
                                    strict=True):
        assert n_raw == rn
        assert (b is None) == (rb is None)
        if b is not None:
            np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(mine.cursor_rows(), ref.cursor_rows())
        if kind == "dual":
            np.testing.assert_array_equal(_rows6(mine.take_v6()), _rows6(ref.take_v6()))
        n += 1
    assert n > len(asg)
    np.testing.assert_array_equal(mine.cursor_rows(), ref.cursor_rows())
    assert mine.done == ref.done == {0, 1, 2, 3}
    assert (mine.packer.parsed, mine.packer.skipped) == (ref.packer.parsed, ref.packer.skipped)
    assert mine.v6_digests == ref.v6_digests


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_global_skip_offset_is_refused(corpora, side):
    _td, packed, rpacked, shards = corpora["v4"]
    src = (_ShardCursorSource(packed, [(0, shards[0], 0)], False) if side == "port"
           else rstream._ShardCursorSource(rpacked, [(0, shards[0], 0)], False))
    err = errors.AnalysisError if side == "port" else rerrors.AnalysisError
    with pytest.raises(err, match="per-shard cursors"):
        next(iter(src.batches(5, 64)))


def test_cursor_rows_split_past_two_to_the_32():
    src = _ShardCursorSource.__new__(_ShardCursorSource)
    src.cursors, src.done = {4: 2**33 + 7, 1: 5}, {1}
    np.testing.assert_array_equal(src.cursor_rows(),
                                  np.array([[1, 5, 0, 1], [4, 7, 2, 0]], dtype=np.uint32))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("side", ["port", "ref"])
def test_prefetch_commits_only_consumed_batches_cursors(corpora, native, side):
    """Depth 2: after the loop takes batch k, the wrapper shows batch k's
    cursors, while the producer's source is already past it."""
    _td, packed, rpacked, shards = corpora["v4"]
    if native and side == "ref":
        ensure_reference_native()
    asg = _assignments(shards)
    make = ((lambda: _ShardCursorSource(packed, asg, native)) if side == "port"
            else (lambda: rstream._ShardCursorSource(rpacked, asg, native)))
    wrap = PrefetchingSource if side == "port" else ringest.PrefetchingSource
    plain = make()
    want = [plain.cursor_rows()]
    for _ in plain.batches(0, 64):
        want.append(plain.cursor_rows())
    final = plain.cursor_rows()  # past the last batch: its shard is done too
    inner = make()
    src = wrap(inner, 2)
    try:
        np.testing.assert_array_equal(src.cursor_rows(), want[0])
        ahead = 0
        for k, _b in enumerate(src.batches(0, 64), start=1):
            deadline = time.monotonic() + 10
            while (not np.array_equal(inner.cursor_rows(), final)
                   and src._pumps[0].q.qsize() < 2 and time.monotonic() < deadline):
                time.sleep(0.005)  # let the producer run ahead
            np.testing.assert_array_equal(src.cursor_rows(), want[k])
            ahead += not np.array_equal(inner.cursor_rows(), want[k])
        assert k == len(want) - 1
        assert ahead >= k - 2  # the producer was ahead of all but the last batches
        # the loop consumed nothing past the last batch
        np.testing.assert_array_equal(src.cursor_rows(), want[-1])
        np.testing.assert_array_equal(inner.cursor_rows(), final)
    finally:
        src.close()


# ---------------------------------------------------------------------------
# The -elastic fingerprint and a one-process gloo elastic tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", [
    dict(),
    dict(cms_width=1 << 12, cms_depth=3, hll_p=9, topk_sample_shift=2),
    dict(exact_counts=False, batch_size=1000),
    dict(layout="stacked", batch_size=96),
])
@pytest.mark.parametrize("kind", ["v4", "dual"])
def test_elastic_fingerprint_is_the_references(corpora, geometry, kind):
    _td, packed, rpacked, _ = corpora[kind]
    sk = {k: geometry[k] for k in ("cms_width", "cms_depth", "hll_p", "topk_sample_shift")
          if k in geometry}
    top = {k: v for k, v in geometry.items() if k not in sk}
    mine = ckpt.fingerprint(packed, AnalysisConfig(sketch=SketchConfig(**sk), **top),
                            lane=0, n_shards=1) + "-elastic"
    ref = rckpt.fingerprint(rpacked, JConfig(sketch=JSketch(**sk), **top), 1, 0) + "-elastic"
    assert mine == ref


def _spec(epoch_dir, shards, epoch):
    snap = ckpt.load(epoch_dir)
    _s, cursors, done = elastic.manifest_of(snap)
    return elastic.ElasticRunSpec(
        epoch_dir=epoch_dir, shards=shards,
        assignments=elastic.assign_shards(shards, cursors, done, 1)[0], snapshot=snap,
        base_cursors=cursors, base_done=done, epoch=epoch)


@pytest.mark.parametrize("kind", ["v4", "dual"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("depth", [0, 2])
def test_stopped_tier_resumes_from_its_epoch_to_the_uninterrupted_registers(
        corpora, tmp_path, kind, native, depth):
    td, packed, rpacked, shards = corpora[kind]
    cfg = AnalysisConfig(batch_size=64, sketch=SketchConfig(**SKETCH), device="cpu",
                         checkpoint_every_chunks=3, prefetch_depth=depth)
    full, regs = run_stream_file(packed, shards,
                                 dataclasses.replace(cfg, checkpoint_every_chunks=0),
                                 native=native, return_state=True)
    total = sum(sum(1 for _ in open(p)) for p in shards)
    epoch_dir = str(tmp_path / "epoch")
    dist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout=60, device="cpu")
    try:
        run_stream_file_distributed(packed, [], cfg, native=native, max_chunks=7,
                                    elastic=_spec(epoch_dir, shards, 0))
        snap = ckpt.load(epoch_dir)
        # the cadence's last save before the stop (v6 chunks count too)
        assert snap.n_chunks == 6 if kind == "v4" else snap.n_chunks >= 3
        _s, cursors, done = elastic.manifest_of(snap)
        assert 0 < sum(cursors.values()) < total and snap.lines_consumed < total
        # the reference loads the port's epoch to the same manifest and identity
        rsnap = rckpt.load(epoch_dir)
        assert relastic.manifest_of(rsnap) == elastic.manifest_of(snap)
        rcfg = JConfig(batch_size=64, sketch=JSketch(**SKETCH))
        assert rsnap.fingerprint == rckpt.fingerprint(rpacked, rcfg, 1, 0) + "-elastic"
        rep, got = run_stream_file_distributed(packed, [], cfg, native=native,
                                               return_state=True,
                                               elastic=_spec(epoch_dir, shards, 1))
    finally:
        dist.shutdown()
    for k in REGISTERS:
        np.testing.assert_array_equal(got[k], regs[k], err_msg=k)
    t, f = json.loads(rep.to_json())["totals"], json.loads(full.to_json())["totals"]
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert t[k] == f[k], k
    assert (t["elastic_epoch"], t["processes"]) == (1, 1)
    assert json.loads(rep.to_json())["unused"] == json.loads(full.to_json())["unused"]
    # the final epoch covers every shard
    _s, cursors, done = elastic.manifest_of(ckpt.load(epoch_dir))
    assert cursors == {i: sum(1 for _ in open(p)) for i, p in enumerate(shards)}


def test_an_epoch_of_another_geometry_is_refused(corpora, tmp_path):
    _td, packed, _r, shards = corpora["v4"]
    cfg = AnalysisConfig(batch_size=64, sketch=SketchConfig(**SKETCH), device="cpu",
                         checkpoint_every_chunks=2)
    epoch_dir = str(tmp_path / "epoch")
    dist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout=60, device="cpu")
    try:
        run_stream_file_distributed(packed, [], cfg, max_chunks=3,
                                    elastic=_spec(epoch_dir, shards, 0))
        other = dataclasses.replace(cfg, batch_size=32)
        with pytest.raises(ckpt.CheckpointMismatch, match="elastic epoch"):
            run_stream_file_distributed(packed, [], other, elastic=_spec(epoch_dir, shards, 1))
    finally:
        dist.shutdown()


# ---------------------------------------------------------------------------
# Config hand-off, exit codes, the CLI, the flight recorder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    AnalysisConfig(),
    AnalysisConfig(device="cpu", batch_size=96, fault_plan="stream.device_put.fail@3:2",
                   retry_policy="device_put=5/0.001", blackbox_dir="/tmp/bb",
                   sketch=SketchConfig(cms_width=1 << 12, hll_p=9, topk_every=4)),
    AnalysisConfig(layout="stacked", stacked_lane=8, prefetch_depth=0, mesh_shape="hybrid",
                   mesh_dcn=2, checkpoint_every_chunks=5, exact_counts=False),
])
def test_config_round_trips_through_json(cfg):
    d = json.loads(json.dumps(cfg.to_dict()))
    back = AnalysisConfig.from_dict(d)
    assert back == cfg and back.device == cfg.device
    assert isinstance(back.sketch, SketchConfig)


def test_exit_codes_are_the_references():
    assert errors.exit_code_for(errors.ReformBudgetExhausted("x")) == 7
    assert rerrors.exit_code_for(rerrors.ReformBudgetExhausted("x")) == 7
    assert errors.EXIT_REFORM_BUDGET == rerrors.EXIT_REFORM_BUDGET == 7
    assert errors.EXIT_CODE_NAMES == rerrors.EXIT_CODE_NAMES
    assert errors.exit_code_for(elastic.FormationTimeout("x")) == 6
    assert rerrors.exit_code_for(relastic.FormationTimeout("x")) == 6
    assert (elastic.DIE_RC, elastic.STALE_SEC, elastic.KILL_GRACE_SEC, elastic.HB_INTERVAL,
            elastic.FORM_TIMEOUT_SEC) == (relastic.DIE_RC, relastic.STALE_SEC,
                                          relastic.KILL_GRACE_SEC, relastic.HB_INTERVAL,
                                          relastic.FORM_TIMEOUT_SEC)


CLI_REFUSALS = {
    "no-distributed": ("--elastic",),
    "stdin": ("--distributed", "--elastic", "STDIN"),
    "wire": ("--distributed", "--elastic", "WIRE"),
    "no-num-processes": ("--distributed", "--elastic", "--process-id", "0"),
    "no-process-id": ("--distributed", "--elastic", "--num-processes", "2"),
    "coordinator": ("--distributed", "--elastic", "--num-processes", "2", "--process-id",
                    "0", "--coordinator", "127.0.0.1:1"),
    "no-elastic-dir": ("--distributed", "--elastic", "--num-processes", "2",
                       "--process-id", "0"),
    "no-json": ("--distributed", "--elastic", "--num-processes", "2", "--process-id", "0",
                "--elastic-dir", "ELDIR", "NOJSON"),
    "static-analysis": ("--distributed", "--elastic", "--num-processes", "2",
                        "--process-id", "0", "--elastic-dir", "ELDIR", "--static-analysis"),
    "no-cadence": ("--distributed", "--elastic", "--num-processes", "2", "--process-id",
                   "0", "--elastic-dir", "ELDIR", "NOCADENCE"),
    "oracle": ("--elastic", "--backend", "oracle", "--acl-configs", "CFG"),
}


@pytest.mark.parametrize("case", list(CLI_REFUSALS))
def test_cli_refusals_are_the_references(corpora, tmp_path, case, capsys, monkeypatch):
    td, packed, _r, shards = corpora["v4"]
    monkeypatch.chdir(tmp_path)  # neither CLI may write outside it
    rawire = str(tmp_path / "a.rawire")
    wire.convert_logs(packed, [shards[0]], rawire, native=False, block_rows=64)
    (tmp_path / "fw1.cfg").write_text("hostname fw1\n")
    args = CLI_REFUSALS[case]
    logs = {"STDIN": ["-"], "WIRE": [rawire]}.get(next((a for a in args if a in
                                                         ("STDIN", "WIRE")), ""), shards)
    argv = ["run", "--ruleset", str(td / "packed"), "--logs", *logs,
            *[{"ELDIR": str(tmp_path / "el"), "CFG": str(tmp_path / "fw1.cfg")}.get(a, a)
              for a in args if a not in ("STDIN", "WIRE", "NOJSON", "NOCADENCE")]]
    if "NOJSON" not in args:
        argv.append("--json")
    if "NOCADENCE" not in args:
        argv += ["--checkpoint-every", "2"]
    if "--backend" in args:
        argv.remove("--checkpoint-every")
        argv.remove("2")
    capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 2
    mine = capsys.readouterr().err
    assert rcli.main(argv) == 2
    ref = capsys.readouterr().err
    assert ref.strip() and ref.strip() in mine, (mine, ref)
    assert not os.path.exists(tmp_path / "el")


def test_no_card_is_the_plain_runs_exit_one(corpora, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    td, _p, _r, shards = corpora["v4"]
    rc = cli.main(["run", "--ruleset", str(td / "packed"), "--logs", *shards, "--distributed",
                   "--elastic", "--elastic-dir", str(tmp_path / "el"), "--num-processes",
                   "1", "--process-id", "0", "--checkpoint-every", "2", "--json"])
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "el")


@pytest.mark.parametrize("exit_code, cause", [
    (7, "elastic re-formation budget exhausted (--max-reforms)"),
    (2, None),
])
def test_supervisor_and_worker_shards_merge_into_one_bundle(tmp_path, exit_code, cause):
    from ruleset_analysis_tpu.runtime import flightrec as rflightrec
    from ruleset_analysis_tpu_torch.runtime import flightrec

    reset_all()
    try:
        got = {}
        for name, fr, err in (("port", flightrec, errors), ("ref", rflightrec, rerrors)):
            d = str(tmp_path / f"bb-{name}")
            fr.arm(d, role="elastic-supervisor")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "blackbox-9999.json"), "w") as f:
                json.dump({"kind": "ra-blackbox-shard", "role": "elastic-worker-0-gen0",
                           "pid": 9999, "trigger": "abort", "ring_events": [],
                           "cursors": {"elastic_gen": 0, "elastic_tag": 0}}, f)
            if exit_code == 7:
                fr.note_failure(7)  # a failure the supervisor reported by code alone
            else:
                fr.note_abort(err.AnalysisError("autoscale fault"), 2)
            assert fr.finalize() is not None
            bundle = fr.load_bundle(d)
            diag = fr.diagnose(bundle)
            got[name] = (sorted(s.get("role") for s in bundle["shards"]), bundle["exit_code"],
                         [x["cause"] for x in diag])
            fr.disarm()
        assert got["port"] == got["ref"]
        assert got["port"][0] == ["elastic-supervisor", "elastic-worker-0-gen0"]
        if cause:
            assert got["port"][2][0] == cause
    finally:
        reset_all()
