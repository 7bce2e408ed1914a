"""The port's write-ahead log (runtime/wal.py) against the reference's.

Every case of the reference's tests/test_wal.py runs through both
packages' ``WriteAheadLog`` over the same appends and damage: round
trip, reopen, torn tail, budget eviction, CRC quarantine with exact
loss, damage to the final segment's CRC and framing, ``gc``, ``reset``
and an unwritable directory.  Each case holds the port to the
reference's assertions, then to the reference's own outcome: the
replayed records, the loss accounting, ``stats()`` and the directory's
files byte for byte.  Then the same appends give byte-identical segment
files (v1 and tenant-tagged v2 records), and each package replays a
directory the other wrote with the same records and ``stats()``.
"""

import os
import struct

import pytest

from ruleset_analysis_tpu import errors as rerrors
from ruleset_analysis_tpu.runtime import wal as rwal
from ruleset_analysis_tpu_torch import errors
from ruleset_analysis_tpu_torch.runtime import wal

SIDES = {"port": (wal, errors), "ref": (rwal, rerrors)}
SEG = 4096


def _fill(mod, d, n, *, segment=SEG, budget=1 << 20, width=100):
    w = mod.WriteAheadLog(str(d), segment_bytes=segment, budget_bytes=budget)
    for i in range(n):
        assert w.append(f"{'x' * width} {i}") == i
    w.close()
    return w


def _open(mod, d, budget=1 << 20):
    return mod.WriteAheadLog(str(d), segment_bytes=SEG, budget_bytes=budget)


def _segments(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".wal"))


def _files(d) -> dict:
    """Every file under a directory: relative path -> bytes."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return dict(sorted(out.items()))


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _lost(w) -> tuple:
    return (w.replay_lost, w.replay_lost_unknown, list(w.quarantined))


# ---------------------------------------------------------------------------
# The reference's cases, each a function of (wal module, errors module, dir)
# returning what it observed
# ---------------------------------------------------------------------------


def case_round_trip_and_suffix_replay(mod, err, d):
    _fill(mod, d, 50)
    w = _open(mod, d)
    assert w.next_seq == 50  # scan-on-open recovers the append cursor
    seen = []
    for start in (0, 17, 49, 50):
        got = list(w.replay(start))
        assert [s for s, _, _t in got] == list(range(start, 50))
        assert all(line == f"{'x' * 100} {s}" for s, line, _t in got)
        assert all(t == mod.DEFAULT_TENANT for _s, _l, t in got)
        assert w.replay_lost == 0 and not w.replay_lost_unknown
        seen.append(got)
    w.close()
    return seen, w.stats()


def case_append_resumes_after_reopen(mod, err, d):
    _fill(mod, d, 10)
    w = _open(mod, d)
    assert w.append("late line") == 10
    w.close()
    w2 = _open(mod, d)
    got = list(w2.replay(9))
    assert [s for s, _, _t in got] == [9, 10]
    assert got[-1][1] == "late line"
    w2.close()
    return got, w.stats(), w2.stats()


def case_torn_tail_is_clean_end_not_corruption(mod, err, d):
    _fill(mod, d, 20)
    last = os.path.join(str(d), _segments(d)[-1])
    with open(last, "ab") as f:
        f.write(struct.pack("<II", 40, 0) + b"only-part-of")  # a torn record
    w = _open(mod, d)
    assert w.next_seq == 20  # the torn record does not count
    got = list(w.replay(0))
    assert [s for s, _, _t in got] == list(range(20))
    assert w.replay_lost == 0 and not w.quarantined
    w.close()
    return got, _lost(w), w.stats()


def case_budget_eviction_exact_drop_accounting(mod, err, d):
    w = _fill(mod, d, 500, segment=SEG, budget=8192)
    assert w.evicted_segments > 0
    st = w.stats()
    assert st["bytes"] <= 8192
    w2 = _open(mod, d, budget=8192)
    got = list(w2.replay(0))
    first = got[0][0]
    # the gap [0, first) is exactly the evicted records, nothing else
    assert w2.replay_lost == first == w.evicted_records
    assert [s for s, _, _t in got] == list(range(first, 500))
    w2.close()
    return got, st, _lost(w2), w2.stats()


def case_crc_corruption_quarantines_segment_exact_loss(mod, err, d):
    _fill(mod, d, 300)
    segs = _segments(d)
    assert len(segs) >= 3
    victim = os.path.join(str(d), segs[1])
    _flip(victim, mod.HEADER_BYTES + 8 + 20)  # into record 0's payload
    w = _open(mod, d)
    got = list(w.replay(0))
    assert len(got) + w.replay_lost == 300
    assert w.replay_lost > 0 and not w.replay_lost_unknown
    assert w.quarantined == [segs[1] + ".quarantined"]
    assert os.path.exists(victim + ".quarantined")
    assert not os.path.exists(victim)
    # the surviving seqs are a prefix and a suffix with one gap: never a
    # silently renumbered stream
    seqs = [s for s, _, _t in got]
    gaps = [(a, b) for a, b in zip(seqs, seqs[1:]) if b != a + 1]
    assert len(gaps) == 1
    a, b = gaps[0]
    assert b - a - 1 == w.replay_lost
    w.close()
    return got, _lost(w), w.stats()


def case_final_segment_crc_damage_is_countable(mod, err, d):
    _fill(mod, d, 300)
    victim = os.path.join(str(d), _segments(d)[-1])
    _flip(victim, mod.HEADER_BYTES + 8 + 3)
    w = _open(mod, d)
    got = list(w.replay(0))
    assert len(got) + w.replay_lost == 300
    assert not w.replay_lost_unknown
    w.close()
    return got, _lost(w), w.stats()


def case_framing_damage_in_final_segment_marks_unknown(mod, err, d):
    _fill(mod, d, 300)
    victim = os.path.join(str(d), _segments(d)[-1])
    with open(victim, "r+b") as f:
        f.seek(mod.HEADER_BYTES)  # record 0's length word
        f.write(struct.pack("<I", 0xFFFFFFFF))
    w = _open(mod, d)
    got = list(w.replay(0))
    assert w.replay_lost_unknown
    assert any(n.endswith(".quarantined") for n in os.listdir(d))
    w.close()
    return got, _lost(w), w.stats()


def case_gc_releases_checkpoint_covered_segments_only(mod, err, d):
    w = _fill(mod, d, 200)
    w2 = _open(mod, d)
    before = len(_segments(d))
    freed = w2.gc(upto_seq=100)
    after = len(_segments(d))
    assert after < before
    # every record >= 100 still replays (the uncheckpointed tail)
    got = list(w2.replay(100))
    assert [s for s, _, _t in got] == list(range(100, 200))
    assert w2.replay_lost == 0
    w2.close()
    assert w.appended == 200
    return freed, got, w2.stats()


def case_reset_starts_fresh(mod, err, d):
    _fill(mod, d, 30)
    w = _open(mod, d)
    w.reset()
    assert w.next_seq == 0 and not _segments(d)
    assert w.append("fresh") == 0
    w.close()
    return w.stats()


def case_unwritable_dir_is_typed(mod, err, d):
    blocker = d / "file"
    blocker.write_text("not a dir")
    with pytest.raises(err.WalQuarantine) as ei:
        mod.WriteAheadLog(str(blocker / "wal"))
    assert isinstance(ei.value, err.AnalysisError)
    assert err.exit_code_for(ei.value) == 1
    assert mod.MAGIC.startswith(b"RAWAL1")
    return str(ei.value).replace(str(d), "D")


def case_refused_arguments_are_typed(mod, err, d):
    out = []
    for kw in ({"segment_bytes": 1024}, {"segment_bytes": SEG, "budget_bytes": SEG}):
        with pytest.raises(err.WalQuarantine) as ei:
            mod.WriteAheadLog(str(d / "w"), **kw)
        out.append(str(ei.value))
    w = _open(mod, d / "w")
    with pytest.raises(err.WalQuarantine) as ei:
        w.append("x", tenant="t" * 300)
    out.append(str(ei.value))
    w.close()
    return out


def case_read_record_point_reads_and_damage(mod, err, d):
    _fill(mod, d, 120)
    w = _open(mod, d)
    reads = [w.read_record(s) for s in (0, 1, 37, 119, 120, 10_000)]
    assert reads[0] == (f"{'x' * 100} 0", mod.DEFAULT_TENANT)
    assert reads[-2:] == [None, None]
    segs = _segments(d)
    _flip(os.path.join(str(d), segs[0]), mod.HEADER_BYTES + 8 + 5)
    damaged = w.read_record(0)
    assert damaged is None and w.quarantined == [segs[0] + ".quarantined"]
    assert w.read_record(119) == reads[3]  # the successors are untouched
    w.close()
    return reads, damaged, _lost(w), w.stats()


def case_tenant_records_replay_under_their_keys(mod, err, d):
    w = mod.WriteAheadLog(str(d), segment_bytes=SEG, budget_bytes=1 << 20)
    tenants = ["t0", "tenant-é", mod.DEFAULT_TENANT, ""]
    for i in range(90):
        w.append(f"line {i} ñ", tenant=tenants[i % len(tenants)])
    w.sync()
    got = list(w.replay(3))
    assert [(s, t) for s, _l, t in got] == [(s, tenants[s % 4]) for s in range(3, 90)]
    w.close()
    return got, w.stats()


CASES = {f.__name__[len("case_"):]: f for f in (
    case_round_trip_and_suffix_replay,
    case_append_resumes_after_reopen,
    case_torn_tail_is_clean_end_not_corruption,
    case_budget_eviction_exact_drop_accounting,
    case_crc_corruption_quarantines_segment_exact_loss,
    case_final_segment_crc_damage_is_countable,
    case_framing_damage_in_final_segment_marks_unknown,
    case_gc_releases_checkpoint_covered_segments_only,
    case_reset_starts_fresh,
    case_unwritable_dir_is_typed,
    case_refused_arguments_are_typed,
    case_read_record_point_reads_and_damage,
    case_tenant_records_replay_under_their_keys,
)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_as_the_reference(tmp_path, name):
    got = {}
    for side, (mod, err) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        got[side] = (CASES[name](mod, err, d), _files(d))
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Byte identity and cross replay
# ---------------------------------------------------------------------------


def _v1(mod):
    """A writer of v1 segments (payload = the line), the format before
    tenant-tagged records."""
    return type("V1Log", (mod.WriteAheadLog,), {"_WRITE_MAGIC": mod.MAGIC})


def _appends(mod, d, kind: str, n: int = 400, budget: int = 1 << 20):
    if kind == "v1":
        w = _v1(mod)(str(d), segment_bytes=SEG, budget_bytes=budget)
        seqs = [w.append_bytes(f"v1 line {i} é".encode()) for i in range(n)]
    else:
        w = mod.WriteAheadLog(str(d), segment_bytes=SEG, budget_bytes=budget)
        seqs = [w.append(f"v2 line {i} é", tenant=f"t{i % 3}") for i in range(n)]
    w.close()
    return seqs, w.stats()


@pytest.mark.parametrize("kind", ["v1", "v2"])
@pytest.mark.parametrize("budget", [1 << 20, 3 * SEG])
def test_same_appends_give_the_same_bytes(tmp_path, kind, budget):
    got = {side: (_appends(mod, tmp_path / side, kind, budget=budget),
                  _files(tmp_path / side))
           for side, (mod, _e) in SIDES.items()}
    assert got["port"] == got["ref"]
    files = got["port"][1]
    assert len(files) > 1 and all(n.startswith("seg-") for n in files)
    magic = wal.MAGIC if kind == "v1" else wal.MAGIC2
    assert all(b[:8] == magic for b in files.values())


def _damage(d, how: str) -> None:
    segs = _segments(d)
    if how == "crc":
        _flip(os.path.join(str(d), segs[1]), wal.HEADER_BYTES + 8 + 7)
    elif how == "torn":
        with open(os.path.join(str(d), segs[-1]), "ab") as f:
            f.write(struct.pack("<II", 64, 0) + b"torn")
    elif how == "framing":
        with open(os.path.join(str(d), segs[-1]), "r+b") as f:
            f.seek(wal.HEADER_BYTES)
            f.write(struct.pack("<I", 0xFFFFFFFF))


@pytest.mark.parametrize("how", ["clean", "crc", "torn", "framing"])
@pytest.mark.parametrize("kind", ["v1", "v2"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_replays_the_others_directory(tmp_path, writer, reader, kind, how):
    """One package writes (and damages) a directory; both replay a copy of
    it: the same records, loss accounting, stats() and files after."""
    src = tmp_path / "src"
    _appends(SIDES[writer][0], src, kind)
    _damage(src, how)
    got = {}
    for side in (writer, reader):
        d = tmp_path / side
        d.mkdir()
        for n, b in _files(src).items():
            (d / n).write_bytes(b)
        w = _open(SIDES[side][0], d)
        opened = w.stats()
        records = list(w.replay(5))
        got[side] = (opened, records, _lost(w), w.stats(), _files(d))
        w.close()
    assert got[reader] == got[writer]
    opened, records = got[reader][:2]
    assert opened["appended"] == 0 and opened["evicted_records"] == 0
    if how == "clean":
        assert [s for s, _l, _t in records] == list(range(5, 400))
        want_tenant = (lambda s: wal.DEFAULT_TENANT) if kind == "v1" else (lambda s: f"t{s % 3}")
        assert all(t == want_tenant(s) for s, _l, t in records)
