"""Checkpoint/resume: (stream offset, register files) snapshots.

The port's copy of the reference's ``runtime/checkpoint.py``, in the same
on-disk format, so either package resumes the other's snapshots.  The
registers are mergeable, so a snapshot is the exact analysis of lines
``[0, offset)``: resume loads the registers, skips ``offset`` raw lines
(wire rows for a ``.rawire`` input) and streams on, ending bit-identical
to a run that was never stopped.

Format: a snapshot directory ``snap-<n>/`` holding the registers as
``state.npz`` (uint32 arrays under the reference's ``AnalysisState``
field names) and ``manifest.json`` (offset, chunk count, packer
counters, top-K tracker tables, the fingerprint that refuses a resume
against another ruleset, sketch geometry, batch size, layout or input kind,
optional ``extra``, and CRC32s of both files).  A ``LATEST`` pointer
file names the live snapshot; its atomic rename is the commit point, so
a crash at any moment of a save leaves the previous consistent pair, and
superseded snapshots are pruned only after the pointer moves.

The write and fsync of both files run under the ``checkpoint.save``
retry policy (runtime/retrypolicy.py), each attempt into a fresh tmp
directory that a failed attempt removes; the ``checkpoint.torn_state``
and ``checkpoint.torn_manifest`` fault sites tear a file just written.  A
snapshot name taken by an older directory is retried under ``-r<k>``
names, bounded by the same policy's attempts.  A save is a
``checkpoint.save`` span and a ``checkpoint.commit`` instant on an armed
trace, a load a ``checkpoint.load`` span.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
import zipfile
import zlib

import numpy as np

from ..config import AnalysisConfig
from ..errors import CheckpointCorrupt, CheckpointMismatch
from ..hostside.pack import PackedRuleset
from ..ops.topk import TopKTracker
from . import faults, obs, retrypolicy

__all__ = [
    "CheckpointCorrupt",
    "CheckpointMismatch",
    "Snapshot",
    "fingerprint",
    "load",
    "restore_tracker",
    "save",
    "snapshot_of",
    "state_of",
]

STATE_FILE = "state.npz"
MANIFEST_FILE = "manifest.json"
POINTER_FILE = "LATEST"


def fingerprint(packed: PackedRuleset, cfg: AnalysisConfig, lane: int = 0, *,
                n_shards: int = 1) -> str:
    """Identity of (ruleset, sketch geometry, chunking) a snapshot is valid for.

    The reference's string, term for term.  ``n_shards`` is the data
    extent of the mesh the run shards over: the batch pads to a multiple
    of it and each shard selects its own candidates, so a snapshot
    resumes only on a mesh of the same width.  ``lane`` is
    the resolved per-ACL lane width of a stacked run (0 for flat), so
    ``{layout},{lane}`` hashes as ``flat,0`` or ``stacked,<lane>``: the
    layouts never cross-resume.  The caller appends ``-wire`` / ``-wirew``
    for plain / weighted wire input, whose offsets count rows, not lines.
    """
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(packed.rules).tobytes())
    if packed.has_v6:
        # pure-v4 rulesets hash as they did before the v6 data model
        h.update(np.ascontiguousarray(packed.rules6).tobytes())
    h.update(np.ascontiguousarray(packed.deny_key).tobytes())
    s = cfg.sketch
    padded = ((cfg.batch_size + n_shards - 1) // n_shards) * n_shards
    h.update(
        f"{s.cms_width},{s.cms_depth},{s.talk_cms_depth},{s.hll_p},{cfg.exact_counts},"
        f"{padded},{n_shards},{s.topk_chunk_candidates},{s.topk_capacity},"
        f"{cfg.layout},{lane},{s.topk_sample_shift}".encode()
    )
    if s.topk_every != 1:
        h.update(f",topk_every={s.topk_every}".encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Snapshot:
    """Host-side image of one checkpoint."""

    arrays: dict[str, np.ndarray]  # register files, uint32
    lines_consumed: int  # raw lines (wire rows) taken from the input
    n_chunks: int
    parsed: int
    skipped: int
    tracker_tables: dict[int, dict[int, int]]
    fingerprint: str
    #: JSON-serializable schema extension (``{"v6_digests": [[d, s], ...]}``
    #: from the stream loop); None when empty.
    extra: dict | None = None


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _manifest_crc32(manifest: dict) -> int:
    """CRC of the manifest's canonical JSON, without the crc field itself."""
    body = {k: v for k, v in manifest.items() if k != "crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    ) & 0xFFFFFFFF


def _write_tmp(ckpt_dir: str, snap: Snapshot) -> str:
    """Both snapshot files, fsynced, in a fresh ``.tmp-`` directory."""
    tmp_dir = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp-")
    try:
        state_path = os.path.join(tmp_dir, STATE_FILE)
        with open(state_path, "wb") as f:
            np.savez(f, **snap.arrays)
            f.flush()
            os.fsync(f.fileno())
        # fault site: a crash leaving a half-written register file; the
        # pointer never moves, so load() keeps the prior snapshot
        faults.fire("checkpoint.torn_state", path=state_path)
        manifest = {
            "lines_consumed": snap.lines_consumed,
            "n_chunks": snap.n_chunks,
            "parsed": snap.parsed,
            "skipped": snap.skipped,
            "fingerprint": snap.fingerprint,
            "tracker": [[acl, list(table.items())] for acl, table in snap.tracker_tables.items()],
            "state_crc32": _file_crc32(state_path),
        }
        if snap.extra is not None:
            manifest["extra"] = snap.extra
        manifest["crc32"] = _manifest_crc32(manifest)
        manifest_path = os.path.join(tmp_dir, MANIFEST_FILE)
        with open(manifest_path, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("checkpoint.torn_manifest", path=manifest_path)
        # the files and their directory entries are durable BEFORE the
        # pointer can name them
        _fsync_dir(tmp_dir)
    except BaseException:
        _rmtree(tmp_dir)
        raise
    return tmp_dir


def save(ckpt_dir: str, snap: Snapshot) -> None:
    """Write ``snap`` and commit it by renaming the ``LATEST`` pointer."""
    t_save0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    # a transient fault (a torn write, EIO, a momentary ENOSPC) writes
    # again into a fresh tmp dir; a persistent one escalates the original
    # error after the policy's attempts
    tmp_dir = retrypolicy.call("checkpoint.save", lambda: _write_tmp(ckpt_dir, snap))
    # never replace an existing dir (LATEST may name it): a same-chunk
    # re-save takes a fresh name, and the old dir goes in the prune
    snap_name = f"snap-{snap.n_chunks}"
    snap_dir = os.path.join(ckpt_dir, snap_name)
    for retry in range(1, retrypolicy.policy("checkpoint.save").attempts + 1):
        if not os.path.exists(snap_dir):
            break
        snap_name = f"snap-{snap.n_chunks}-r{retry}"
        snap_dir = os.path.join(ckpt_dir, snap_name)
    else:
        _rmtree(tmp_dir)
        raise CheckpointCorrupt(
            f"cannot find a free snapshot name for chunk {snap.n_chunks} "
            f"in {ckpt_dir!r} (storage litter?); clean the checkpoint dir"
        )
    os.replace(tmp_dir, snap_dir)
    _fsync_dir(ckpt_dir)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".ptr.tmp")
    with os.fdopen(fd, "w") as f:
        f.write(snap_name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, POINTER_FILE))  # the commit point
    _fsync_dir(ckpt_dir)
    if obs.active_tracer() is not None:
        # the size stat only when tracing: a disarmed save stays
        # syscall-free past its None-check
        t_save1 = time.perf_counter()
        state_bytes = os.path.getsize(os.path.join(snap_dir, STATE_FILE))
        obs.complete("checkpoint.save", t_save0, t_save1, cat="checkpoint",
                     args={"n_chunks": snap.n_chunks, "bytes": int(state_bytes)})
        obs.instant("checkpoint.commit", args={"snap": snap_name})
        # the reference also pushes a "checkpoint" metrics event here; the
        # metrics plane is not ported yet (ROADMAP A3)
    # prune what the new pointer does not name: superseded snapshots,
    # orphans of a crash before a pointer commit, stale tmp litter
    for entry in os.listdir(ckpt_dir):
        if entry in (snap_name, POINTER_FILE):
            continue
        p = os.path.join(ckpt_dir, entry)
        if entry.startswith("snap-") or entry.startswith(".tmp-"):
            _rmtree(p)
        elif entry.endswith(".ptr.tmp"):
            try:
                os.unlink(p)
            except OSError:
                pass


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _read_pointer(ckpt_dir: str) -> str | None:
    try:
        with open(os.path.join(ckpt_dir, POINTER_FILE), "r", encoding="utf-8") as f:
            return f.read().strip()
    except (FileNotFoundError, NotADirectoryError):
        return None  # nothing was ever committed here
    except UnicodeDecodeError as e:
        # a pointer of non-UTF-8 bytes is storage damage, not "no
        # checkpoint": a None here would silently restart from scratch
        raise CheckpointCorrupt(
            f"checkpoint pointer {os.path.join(ckpt_dir, POINTER_FILE)!r} "
            f"is corrupt ({e}); delete the checkpoint dir (or repair "
            "storage) to proceed"
        ) from e


def _rmtree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def load(ckpt_dir: str) -> Snapshot | None:
    """The committed snapshot, or None when none was ever committed.

    A pointer naming a missing or partial snapshot, a CRC mismatch, or an
    undecodable file raises :class:`CheckpointCorrupt`.
    """
    with obs.span("checkpoint.load", dir=ckpt_dir):
        return _load(ckpt_dir)


def _load(ckpt_dir: str) -> Snapshot | None:
    name = _read_pointer(ckpt_dir)
    if name is None:
        return None
    snap_dir = os.path.join(ckpt_dir, name)
    state_path = os.path.join(snap_dir, STATE_FILE)
    manifest_path = os.path.join(snap_dir, MANIFEST_FILE)
    if not name or not (os.path.exists(state_path) and os.path.exists(manifest_path)):
        # save() makes a snapshot durable before the pointer moves, so a
        # pointer to nothing is storage damage
        raise CheckpointCorrupt(
            f"checkpoint pointer in {ckpt_dir!r} names {name!r} but no "
            "complete snapshot exists there; delete the checkpoint dir (or "
            "repair storage) to proceed"
        )
    try:
        with open(manifest_path, "r", encoding="utf-8") as f:
            m = json.load(f)
        # the manifest CRC catches flips that still decode as JSON (an
        # offset); the state CRC catches npz damage zipfile can miss
        if "crc32" in m and int(m["crc32"]) != _manifest_crc32(m):
            raise ValueError("manifest CRC32 mismatch (bit rot?)")
        if "state_crc32" in m and int(m["state_crc32"]) != _file_crc32(state_path):
            raise ValueError("register payload CRC32 mismatch (bit rot?)")
        with np.load(state_path) as z:
            arrays = {k: z[k] for k in z.files}
        return Snapshot(
            arrays=arrays,
            lines_consumed=int(m["lines_consumed"]),
            n_chunks=int(m["n_chunks"]),
            parsed=int(m["parsed"]),
            skipped=int(m["skipped"]),
            tracker_tables={
                int(acl): {int(k): int(v) for k, v in items} for acl, items in m["tracker"]
            },
            fingerprint=m["fingerprint"],
            extra=m.get("extra"),
        )
    except (ValueError, KeyError, TypeError, OSError, UnicodeDecodeError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(
            f"snapshot {snap_dir!r} is corrupt ({type(e).__name__}: "
            f"{str(e)[:200]}); delete it (or repair storage) to proceed"
        ) from e


def snapshot_of(state, *, lines_consumed: int, n_chunks: int, parsed: int, skipped: int,
                tracker: TopKTracker, fingerprint: str, extra: dict | None = None) -> Snapshot:
    """Host-side Snapshot of a device ``AnalysisState`` (copies the registers
    to the host, which waits for the device)."""
    from ..models.pipeline import state_to_numpy

    return Snapshot(
        arrays=state_to_numpy(state),
        lines_consumed=lines_consumed,
        n_chunks=n_chunks,
        parsed=parsed,
        skipped=skipped,
        tracker_tables=tracker.tables(),
        fingerprint=fingerprint,
        extra=extra,
    )


def state_of(snap: Snapshot, device):
    """The snapshot's registers as an ``AnalysisState`` on ``device``."""
    from ..models.pipeline import state_from_numpy

    return state_from_numpy(snap.arrays, device)


def restore_tracker(snap: Snapshot, capacity: int) -> TopKTracker:
    t = TopKTracker(capacity)
    for acl, table in snap.tracker_tables.items():
        for src, est in table.items():
            t.offer(acl, src, est)
    return t
