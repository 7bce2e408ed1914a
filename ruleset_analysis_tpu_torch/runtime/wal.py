"""Durable ingest WAL and the window lineage ledger: host-side files.

The port's copy of the reference's ``runtime/wal.py``, whole.  Its
segment files are the reference's byte for byte (the same appends give
the same bytes), so either package replays the other's directory, and
its ``lineage.jsonl`` lines are the reference's canonical JSON.

:class:`WriteAheadLog` is a segmented, CRC'd on-disk line spool.  Every
line a serve loop consumes appends here before window accounting, and a
resume replays the tail past the last checkpoint, so an interrupted
window publishes over every delivered line.

- **Segments.**  ``seg-<start_seq>.wal`` files; each holds a 16-byte
  header (magic + little-endian u64 first-record seq) followed by
  length-prefixed records (``u32 len | u32 crc32(payload) | payload``).
  Records are numbered ``start_seq + index`` implicitly, which makes
  every loss exactly countable: the records missing between a
  checkpoint's seq and the first available record is their difference.
- **Durability.**  Appends are single ``os.write`` calls on an O_APPEND
  fd, so a SIGKILL after an append returns cannot lose it (the bytes are
  in the kernel).  ``sync()`` fsyncs the open segment for power-loss
  durability.
- **Bounded disk.**  When live segments exceed ``budget_bytes``, the
  oldest segment is evicted and its record count charged to
  ``evicted_records``.  A later replay from a seq before the surviving
  head reports the gap as ``replay_lost``, never as a silent gap.
- **Corruption.**  A record whose CRC fails, or broken framing in a
  non-final segment, quarantines the segment from that record on: the
  file is renamed ``*.quarantined``, the remaining records are counted
  exactly where a successor segment pins the end seq (unknown only for a
  corrupt final segment's tail), and replay continues with the next
  segment.  A short record at the very end of the final segment is the
  torn tail of the append a kill interrupted: replay ends cleanly there.

:class:`LineageLog` is the append-only ``lineage.jsonl``, one sealed
record per published window (``report.seal_lineage``), written with the
same single-``os.write`` idiom; ``doctor --lineage`` reads it through
:meth:`LineageLog.read`.  The serve loop (runtime/serve.py) is the
WAL's caller and the ledger's writer.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib

from ..errors import AnalysisError, WalQuarantine

MAGIC = b"RAWAL1\x00\x00"  # 8 bytes; v1: the payload is the line
#: v2: payload = u8 tenant-key length | tenant utf-8 | line utf-8.  The
#: version is per segment (header magic), so a v1 spool and the v2
#: segments appended after it replay as one chain; v1 records decode
#: with the default tenant key.
MAGIC2 = b"RAWAL2\x00\x00"
#: tenant key of every v1 record, and of single-tenant appends
DEFAULT_TENANT = "default"
_HDR = struct.Struct("<8sQ")  # magic, start_seq
_REC = struct.Struct("<II")  # payload len, payload crc32
HEADER_BYTES = _HDR.size
#: framing sanity bound: no syslog line is this big (the listener tier
#: drops lines over 1 MiB), so a larger length word means broken framing
MAX_RECORD_BYTES = 4 << 20


def _seg_name(start_seq: int) -> str:
    return f"seg-{start_seq:020d}.wal"


class _BadRecord(Exception):
    """A CRC-valid record that fails its format's payload framing: a
    writer bug, not disk damage, but still a typed quarantine."""


class _Segment:
    __slots__ = ("path", "start", "count", "bytes")

    def __init__(self, path: str, start: int, count: int, nbytes: int):
        self.path = path
        self.start = start
        self.count = count  # records known to be in the file
        self.bytes = nbytes

    @property
    def end(self) -> int:
        return self.start + self.count


class WriteAheadLog:
    """One process's ingest WAL (single writer, scan on open).

    The segment, eviction and quarantine machinery is format-parametric:
    a subclass overrides the three class attributes below and
    :meth:`_decode_record` (the reference's distributed-serve epoch spool
    does) and keeps the O_APPEND durability, the seq-gap loss accounting
    and the typed quarantine.
    """

    #: segment-header magics this format accepts on replay
    _MAGICS: tuple[bytes, ...] = (MAGIC, MAGIC2)
    #: segment-header magic new segments are written with
    _WRITE_MAGIC: bytes = MAGIC2
    #: framing sanity bound for one record's payload
    _MAX_RECORD: int = MAX_RECORD_BYTES

    def __init__(
        self,
        wal_dir: str,
        *,
        segment_bytes: int = 1 << 20,
        budget_bytes: int = 64 << 20,
    ):
        if segment_bytes < 4096:
            raise WalQuarantine(
                f"wal segment_bytes must be >= 4096, got {segment_bytes}"
            )
        if budget_bytes < 2 * segment_bytes:
            raise WalQuarantine(
                "wal budget_bytes must be >= 2 * segment_bytes"
            )
        self.dir = os.path.abspath(wal_dir)
        self.segment_bytes = segment_bytes
        self.budget_bytes = budget_bytes
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as e:
            raise WalQuarantine(
                f"cannot create WAL directory {wal_dir!r}: {e}"
            ) from e
        self._lock = threading.Lock()
        self._fd: int | None = None  # open (rolling) segment fd
        self.appended = 0  # records appended by this process
        self.evicted_segments = 0
        self.evicted_records = 0
        #: set by the last replay(): records known lost to eviction or
        #: quarantine before or during it (exact where seq math allows)
        self.replay_lost = 0
        #: True when a corrupt final segment made the tail loss uncountable
        self.replay_lost_unknown = False
        self.quarantined: list[str] = []
        self._segments: list[_Segment] = self._scan()
        self.next_seq = self._segments[-1].end if self._segments else 0

    # -- scan -------------------------------------------------------------
    def _scan(self) -> list[_Segment]:
        """Index the existing segments; only the last needs a record walk
        (every earlier segment's count is pinned by its successor's start
        seq)."""
        segs: list[_Segment] = []
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith("seg-") and n.endswith(".wal")
            )
        except OSError as e:
            raise WalQuarantine(f"cannot scan WAL dir {self.dir!r}: {e}") from e
        starts = []
        for n in names:
            try:
                starts.append((int(n[4:-4]), n))
            except ValueError:
                continue  # a foreign file; ignored
        starts.sort()
        for i, (start, n) in enumerate(starts):
            path = os.path.join(self.dir, n)
            nbytes = os.path.getsize(path)
            if i + 1 < len(starts):
                count = starts[i + 1][0] - start
            else:
                count = self._count_records(path)
            segs.append(_Segment(path, start, count, nbytes))
        return segs

    @classmethod
    def _count_records(cls, path: str) -> int:
        """Record count of the final segment (a torn tail tolerated)."""
        n = 0
        try:
            with open(path, "rb") as f:
                hdr = f.read(HEADER_BYTES)
                if len(hdr) < HEADER_BYTES or hdr[:8] not in cls._MAGICS:
                    return 0  # quarantined at replay; count unknown
                while True:
                    rec = f.read(_REC.size)
                    if len(rec) < _REC.size:
                        return n
                    ln, _crc = _REC.unpack(rec)
                    if ln > cls._MAX_RECORD:
                        return n  # broken framing; replay quarantines
                    payload = f.read(ln)
                    if len(payload) < ln:
                        return n  # torn tail
                    n += 1
        except OSError:
            return n

    # -- append path ------------------------------------------------------
    def _open_segment(self) -> None:
        path = os.path.join(self.dir, _seg_name(self.next_seq))
        # a leftover zero-record segment (or a file with an unreadable
        # header) may hold this name; O_APPEND onto it would double the
        # header, so replace it: it holds no counted records
        if (
            self._segments
            and self._segments[-1].start == self.next_seq
            and self._segments[-1].count == 0
        ):
            self._segments.pop()
        try:
            os.unlink(path)
        except OSError:
            pass
        seg = _Segment(path, self.next_seq, 0, HEADER_BYTES)
        fd = os.open(seg.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.write(fd, _HDR.pack(self._WRITE_MAGIC, seg.start))
        self._fd = fd
        self._segments.append(seg)

    def append(self, line: str, tenant: str = DEFAULT_TENANT) -> int:
        """Spool one line durably; returns its seq (one O_APPEND write:
        a SIGKILL after the return cannot lose it).

        ``tenant`` is the routing key the record replays under (the v2
        format); single-tenant callers leave :data:`DEFAULT_TENANT`.
        """
        tkey = tenant.encode("utf-8", errors="replace")
        if len(tkey) > 255:
            raise WalQuarantine(
                f"tenant key exceeds 255 bytes: {tenant[:64]!r}..."
            )
        payload = (
            bytes((len(tkey),)) + tkey + line.encode("utf-8", errors="replace")
        )
        return self.append_bytes(payload)

    def append_bytes(self, payload: bytes) -> int:
        """Spool one raw payload durably; returns its seq.

        The format-agnostic append path: :meth:`append` frames (tenant,
        line) into it."""
        rec = _REC.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        with self._lock:
            cur = self._segments[-1] if self._segments else None
            if (
                self._fd is None
                or cur is None
                or cur.bytes + len(rec) > self.segment_bytes
            ):
                self._roll()
                cur = self._segments[-1]
            seq = self.next_seq
            os.write(self._fd, rec)
            cur.count += 1
            cur.bytes += len(rec)
            self.next_seq = seq + 1
            self.appended += 1
            self._evict_over_budget()
        return seq

    def _roll(self) -> None:
        if self._fd is not None:
            try:
                os.fsync(self._fd)
            except OSError:
                pass
            os.close(self._fd)
            self._fd = None
        self._open_segment()

    def _evict_over_budget(self) -> None:
        total = sum(s.bytes for s in self._segments)
        while total > self.budget_bytes and len(self._segments) > 1:
            victim = self._segments.pop(0)
            total -= victim.bytes
            self.evicted_segments += 1
            self.evicted_records += victim.count
            try:
                os.unlink(victim.path)
            except OSError:
                pass
            from . import obs

            obs.instant("wal.evict", args={
                "segment": os.path.basename(victim.path),
                "records": victim.count,
            })

    def sync(self) -> None:
        """fsync the rolling segment (the power-loss durability point)."""
        with self._lock:
            if self._fd is not None:
                try:
                    os.fsync(self._fd)
                except OSError:
                    pass

    def gc(self, upto_seq: int) -> int:
        """Drop the segments wholly below ``upto_seq`` (checkpoint-covered).

        Returns the records released.  The rolling segment never drops.
        """
        freed = 0
        with self._lock:
            while len(self._segments) > 1 and self._segments[0].end <= upto_seq:
                seg = self._segments.pop(0)
                freed += seg.count
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
        return freed

    # -- replay path ------------------------------------------------------
    def replay(self, from_seq: int):
        """Yield ``(seq, line, tenant)`` for every record with seq >=
        ``from_seq``.

        v2 segments carry each record's tenant; records of v1 segments
        replay under :data:`DEFAULT_TENANT`.  The loss accounting lands on
        the instance afterwards: ``replay_lost`` counts the records known
        missing (the evicted head gap and quarantined remainders pinned by
        a successor's start seq); ``replay_lost_unknown`` flags a corrupt
        final segment whose tail count nothing pins.  CRC or framing
        damage quarantines the segment (renamed ``*.quarantined``) and
        replay continues: never a crash, never a silent gap.
        """
        self.replay_lost = 0
        self.replay_lost_unknown = False
        segs = list(self._segments)
        if not segs:
            return
        if from_seq < segs[0].start:
            # the evicted head gap: exactly this many records are gone
            self.replay_lost += segs[0].start - from_seq
            from_seq = segs[0].start
        for i, seg in enumerate(segs):
            end = segs[i + 1].start if i + 1 < len(segs) else None
            if end is not None and end <= from_seq:
                continue
            yield from self._replay_segment(seg, from_seq, end)

    def _replay_segment(self, seg: _Segment, from_seq: int, end: int | None):
        try:
            f = open(seg.path, "rb")
        except OSError:
            self._quarantine(
                seg, max(seg.start, from_seq), end, "unreadable",
                countable_final=True,  # the open-time scan counted it
            )
            return
        with f:
            hdr = f.read(HEADER_BYTES)
            if len(hdr) < HEADER_BYTES or hdr[:8] not in self._MAGICS or (
                _HDR.unpack(hdr)[1] != seg.start
            ):
                self._quarantine(
                    seg, max(seg.start, from_seq), end, "bad segment header"
                )
                return
            magic = hdr[:8]
            seq = seg.start
            while True:
                rec = f.read(_REC.size)
                if len(rec) < _REC.size:
                    if end is not None and (rec or seq < end):
                        # framing damage mid-chain, or a short segment whose
                        # successor pins more records than it holds
                        self._quarantine(
                            seg, max(seq, from_seq), end, "truncated record"
                        )
                    return  # a clean end, or the final segment's torn tail
                ln, crc = _REC.unpack(rec)
                if ln > self._MAX_RECORD:
                    self._quarantine(
                        seg, max(seq, from_seq), end, "absurd record length"
                    )
                    return
                payload = f.read(ln)
                if len(payload) < ln:
                    if end is not None:
                        self._quarantine(
                            seg, max(seq, from_seq), end, "truncated payload"
                        )
                    return  # the final segment's torn tail
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    # CRC damage leaves the framing intact, so the scan's
                    # record count still pins the final segment's loss
                    self._quarantine(
                        seg, max(seq, from_seq), end, "record CRC mismatch",
                        countable_final=True,
                    )
                    return
                if seq >= from_seq:
                    try:
                        decoded = self._decode_record(payload, magic)
                    except _BadRecord as bad:
                        # the CRC passed, so a writer bug, not disk
                        # damage: still a typed quarantine
                        self._quarantine(
                            seg, max(seq, from_seq), end, str(bad)
                        )
                        return
                    yield (seq, *decoded)
                seq += 1

    def read_record(self, seq: int) -> tuple | None:
        """Read one record by seq (its decoded tuple), or ``None`` when no
        live segment covers it.

        Walks the covering segment's record headers (seeking past every
        other payload) and CRC-checks only the target, so a point read
        costs one header walk, not a replay of the chain.  Damage found on
        the walk quarantines the segment as replay does, and the read
        returns ``None``: a typed gap, never bad bytes.
        """
        with self._lock:
            seg = next(
                (s for s in self._segments if s.start <= seq < s.end), None
            )
            succ = seg is not None and seg is not self._segments[-1]
        if seg is None:
            return None
        end = seg.end if succ else None
        try:
            f = open(seg.path, "rb")
        except OSError:
            self._quarantine(seg, seg.start, end, "unreadable",
                             countable_final=True)
            return None
        with f:
            hdr = f.read(HEADER_BYTES)
            if len(hdr) < HEADER_BYTES or hdr[:8] not in self._MAGICS or (
                _HDR.unpack(hdr)[1] != seg.start
            ):
                self._quarantine(seg, seg.start, end, "bad segment header")
                return None
            magic = hdr[:8]
            cur = seg.start
            while True:
                rec = f.read(_REC.size)
                if len(rec) < _REC.size:
                    return None  # a torn tail before the target
                ln, crc = _REC.unpack(rec)
                if ln > self._MAX_RECORD:
                    self._quarantine(
                        seg, max(cur, seg.start), end, "absurd record length"
                    )
                    return None
                if cur < seq:
                    f.seek(ln, 1)  # skip the payload unverified
                    cur += 1
                    continue
                payload = f.read(ln)
                if len(payload) < ln:
                    return None  # the torn tail is the target
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    self._quarantine(
                        seg, cur, end, "record CRC mismatch",
                        countable_final=True,
                    )
                    return None
                try:
                    return self._decode_record(payload, magic)
                except _BadRecord as bad:
                    self._quarantine(seg, cur, end, str(bad))
                    return None

    @classmethod
    def _decode_record(cls, payload: bytes, magic: bytes) -> tuple:
        """Decode one CRC-valid payload into the tuple that replay yields
        after the seq, ``(line, tenant)``; raise :class:`_BadRecord` on
        framing a CRC cannot catch."""
        if magic == MAGIC2:
            tlen = payload[0] if payload else 0
            if 1 + tlen > len(payload):
                raise _BadRecord("bad tenant framing")
            tenant = payload[1:1 + tlen].decode("utf-8", errors="replace")
            line = payload[1 + tlen:].decode("utf-8", errors="replace")
        else:
            tenant = DEFAULT_TENANT
            line = payload.decode("utf-8", errors="replace")
        return line, tenant

    def _note_lost(self, seg: _Segment, from_seq: int, end: int | None,
                   why: str, countable_final: bool) -> None:
        if end is not None:
            self.replay_lost += max(0, end - from_seq)
        elif countable_final and seg.count:
            # the final segment with intact framing: the open-time scan's
            # record count pins the loss exactly
            self.replay_lost += max(0, seg.end - from_seq)
        else:
            self.replay_lost_unknown = True
        from . import obs

        obs.instant("wal.quarantine", args={
            "segment": os.path.basename(seg.path), "reason": why,
            "lost_from_seq": from_seq,
        })

    def _quarantine(self, seg: _Segment, from_seq: int, end: int | None,
                    why: str, countable_final: bool = False) -> None:
        """Typed quarantine: rename the damaged segment aside, count the
        loss where seq math pins it, keep replaying the successors."""
        self._note_lost(seg, from_seq, end, why, countable_final)
        qpath = seg.path + ".quarantined"
        try:
            os.replace(seg.path, qpath)
        except OSError:
            qpath = seg.path  # the rename failed; left in place, still counted
        self.quarantined.append(os.path.basename(qpath))
        with self._lock:
            if seg in self._segments:
                self._segments.remove(seg)
            if not self._segments:
                # the writer must not append into a quarantined chain
                self._fd = None

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Delete every segment (a fresh, non-resumed run starts a fresh
        log, so a stale spool never grows the directory)."""
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
            for seg in self._segments:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
            self._segments = []
            self.next_seq = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "next_seq": self.next_seq,
                "appended": self.appended,
                "segments": len(self._segments),
                "bytes": int(sum(s.bytes for s in self._segments)),
                "evicted_segments": self.evicted_segments,
                "evicted_records": self.evicted_records,
                "quarantined": list(self.quarantined),
            }

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.fsync(self._fd)
                except OSError:
                    pass
                os.close(self._fd)
                self._fd = None


class LineageLog:
    """Append-only ``lineage.jsonl``: the window provenance ledger.

    One JSON object per published window, written with the WAL's
    durability idiom, a single ``os.write`` on an O_APPEND fd, so a
    record is either wholly present (newline-terminated) or absent.  A
    SIGKILL can tear at most the final line, which has no newline, and
    :meth:`read` skips it as WAL replay treats a torn tail: a clean end,
    not corruption.  An append is a core publication step: it fires the
    ``lineage.append`` fault site and lets failures propagate typed (a
    window must never publish without its lineage record), with no retry.
    """

    NAME = "lineage.jsonl"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fd = os.open(
            path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
        )
        self.appended = 0

    def append(self, record: dict) -> None:
        from . import faults

        faults.fire("lineage.append")
        data = (
            json.dumps(record, sort_keys=True, separators=(",", ":")) + "\n"
        ).encode("utf-8")
        try:
            with self._lock:
                os.write(self._fd, data)
                self.appended += 1
        except OSError as e:
            raise AnalysisError(
                f"lineage append failed for window "
                f"{record.get('window')}: {e}"
            ) from e

    def sync(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.fsync(self._fd)
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse a lineage log, tolerating a torn final line (only)."""
        out: list[dict] = []
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return out
        lines = raw.split(b"\n")
        lines.pop()  # b"" after a complete final record; else the torn append
        for ln in lines:
            if not ln.strip():
                continue
            out.append(json.loads(ln))  # damage before the final line is corruption
        return out
