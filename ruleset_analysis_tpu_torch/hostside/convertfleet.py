"""Parallel convert fleet: one corpus into pre-coalesced RAWIREv3 shards
and a merge manifest, across worker processes.

One ``convert`` parses on one core; the fleet spreads the parse the way
the feeder does, with its exact-raw-line descriptor model:

- The coordinator chops the corpus into descriptors of exactly
  ``batch_size`` raw lines (``feeder._scan_batches``: byte ranges only,
  descriptors never span files) and gives N spawned workers CONTIGUOUS
  descriptor ranges.
- Each worker parses its range with its own :class:`NativePacker` and
  writes one complete weighted RAWIREv3 shard; rows coalesce per
  descriptor batch into (unique row, weight) pairs.
- The coordinator writes ``out`` as a MANIFEST: a small JSON file that
  lists the shards in corpus order with their row and line accounting
  and the ruleset fingerprint.  ``run`` expands a manifest into its
  shard list (:func:`expand_wire_inputs`), and the multi-file wire
  reader concatenates the shards and counts resume offsets in stored
  rows across them, so a fleet output is one corpus.

The descriptor set is a function of (corpus bytes, batch_size) alone and
coalescing is per descriptor batch, so the concatenated row stream, and
every report and resume offset over it, is the same for any worker
count.  The shards and the manifest are the reference's, byte for byte.
This module imports no ``torch``: its workers are spawned.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import queue

import numpy as np

from ..errors import AnalysisError, FeedWorkerError, NativeParserUnavailable
from . import fastparse
from .feeder import _attach, _scan_batches, _segment, _stop_processes
from .pack import (
    T_VALID, TUPLE_COLS, PackedRuleset, coalesce_wire, coalesce_wire6, compact_batch,
    compact_batch6,
)
from .wire import DEFAULT_BLOCK_ROWS, WireWriter, ruleset_fingerprint

#: Manifest identity: the first bytes of the JSON file, which the cheap
#: sniff in :func:`is_manifest_file` keys on (as the wire magic is).
MANIFEST_MAGIC = "RAWIRE-MANIFEST-v1"
_MANIFEST_PREFIX = ('{"magic": "' + MANIFEST_MAGIC + '"').encode()


def is_manifest_file(path: str) -> bool:
    """True if ``path`` is a convert-fleet manifest (a byte sniff)."""
    try:
        with open(path, "rb") as f:
            return f.read(len(_MANIFEST_PREFIX)) == _MANIFEST_PREFIX
    except OSError:
        return False


def read_manifest(path: str) -> dict:
    """Load and check a manifest; shard paths resolve relative to it.

    The read runs under the ``wire.read`` retry policy: a transient
    open or read fault reads again with seeded backoff, a persistent one
    is the AnalysisError below.
    """
    from ..runtime import faults, retrypolicy

    def _read():
        faults.fire("stream.wire.read.fail")
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    try:
        m = retrypolicy.call("wire.read", _read)
    except (OSError, ValueError) as e:
        raise AnalysisError(f"cannot read manifest {path!r}: {e}") from e
    if m.get("magic") != MANIFEST_MAGIC:
        raise AnalysisError(f"{path!r} is not a convert-fleet manifest")
    base = os.path.dirname(os.path.abspath(path))
    m["shard_paths"] = [s if os.path.isabs(s) else os.path.join(base, s)
                        for s in (e["name"] for e in m["shards"])]
    missing = [p for p in m["shard_paths"] if not os.path.exists(p)]
    if missing:
        raise AnalysisError(f"manifest {path!r} names missing shard(s): {missing[:3]}")
    return m


def expand_wire_inputs(paths: list[str]) -> list[str]:
    """Each manifest in ``paths`` replaced by its shard list, in order.

    Other paths (wire or text files, ``-``) pass through untouched, so
    callers route the expanded list through the usual wire/text sniff.
    """
    out: list[str] = []
    for p in paths:
        if p != "-" and is_manifest_file(p):
            out.extend(read_manifest(p)["shard_paths"])
        else:
            out.append(p)
    return out


def _shard_name(out_path: str, k: int, n: int) -> str:
    return f"{out_path}.shard{k:02d}-of-{n:02d}"


def _convert_descs(packed: PackedRuleset, paths: list[str], descs: list[tuple],
                   shard_path: str, *, block_rows: int, batch_size: int) -> dict:
    """Parse one contiguous descriptor range into one complete weighted shard.

    Runs inline for one worker and inside each spawned worker otherwise:
    one code path, so their outputs cannot drift.
    """
    packer = fastparse.NativePacker(packed)
    rows_cap = (2 if packed.bindings_out else 1) * batch_size
    out = np.empty((TUPLE_COLS, rows_cap), dtype=np.uint32)
    files: dict[int, object] = {}
    w = WireWriter(shard_path, ruleset_fingerprint(packed), block_rows, weighted=True)
    try:
        if packed.has_v6:
            w.begin6()
        last_skipped = 0
        for path_i, offset, nbytes, n_lines in descs:
            f = files.get(path_i)
            if f is None:
                f = files[path_i] = open(paths[path_i], "rb")
            f.seek(offset)
            data = f.read(nbytes)
            _, lines, _used = packer.pack_chunk(data, rows_cap, final=True, max_lines=n_lines,
                                                n_threads=1, out=out)
            if lines != n_lines:
                raise AnalysisError(
                    f"descriptor of {n_lines} lines parsed as {lines}: the input changed "
                    "during the convert"
                )
            wire4 = coalesce_wire(compact_batch(out[:, out[T_VALID] == 1]))
            w.add(wire4, n_lines, packer.skipped - last_skipped)
            last_skipped = packer.skipped
            if packed.has_v6:
                rows6 = packer.take_v6()
                if len(rows6):
                    wire6 = coalesce_wire6(compact_batch6(np.asarray(rows6, dtype=np.uint32).T))
                    w.add6(wire6, 0, 0)
        w.close()
    except BaseException:
        w.abort()  # the partial magic: every reader refuses the torn shard
        raise
    finally:
        for f in files.values():
            f.close()
    return {
        "name": os.path.basename(shard_path),
        "rows": w.n_rows,
        "rows6": w.n6_rows,
        "raw_lines": w.raw_lines,
        "evals": w.n_evals,
        "skipped": w.n_skipped,
        "bytes": os.path.getsize(shard_path),
    }


def _fleet_worker(lib_path, shm_name, blob_at, paths, descs, shard_path, block_rows,
                  batch_size, k, done_q):
    """Spawned worker: one descriptor range -> one shard; its stats via the queue."""
    from ..runtime import obs

    obs.note_role("convert-worker")
    try:
        fastparse.use_library(lib_path)
        shm, packed = _attach(shm_name, blob_at)
        shm.close()
        stats = _convert_descs(packed, paths, descs, shard_path, block_rows=block_rows,
                               batch_size=batch_size)
    except Exception as e:  # forward instead of dying silently
        done_q.put(("error", k, f"{type(e).__name__}: {e}"))
        return
    done_q.put(("ok", k, stats))


def _run_fleet(packed, paths, spans, shard_paths, block_rows, batch_size,
               per_shard: list) -> None:
    """Spawn one worker a span and collect their stats into ``per_shard``."""
    lib = str(fastparse.build())  # built here, before any worker starts
    ctx = multiprocessing.get_context("spawn")
    done_q = ctx.Queue()
    # the ruleset travels in a segment, so the workers start side by side
    shm, blob_at = _segment(packed, 0)
    procs = []
    try:
        for k, span in enumerate(spans):
            p = ctx.Process(target=_fleet_worker,
                            args=(lib, shm.name, blob_at, paths, span, shard_paths[k],
                                  block_rows, batch_size, k, done_q),
                            daemon=True)
            p.start()
            procs.append(p)
        got = 0
        while got < len(spans):
            try:
                msg = done_q.get(timeout=5.0)
            except queue.Empty:
                dead = [p.pid for p in procs if not p.is_alive()]
                if not dead:
                    continue
                # a worker died without reporting: look once more, in
                # case its message is still in flight
                try:
                    msg = done_q.get(timeout=2.0)
                except queue.Empty:
                    raise FeedWorkerError(
                        f"convert worker(s) {dead} died without reporting (killed by the OS?)"
                    ) from None
            if msg[0] == "error":
                raise FeedWorkerError(f"convert worker {msg[1]} failed: {msg[2]}")
            _, k, stats = msg
            per_shard[k] = stats
            got += 1
    finally:
        _stop_processes(procs, [], done_q, [done_q])
        shm.close()
        shm.unlink()


def convert_logs_fleet(packed: PackedRuleset, log_paths: list[str], out_path: str, *,
                       workers: int, batch_size: int = DEFAULT_BLOCK_ROWS,
                       block_rows: int = DEFAULT_BLOCK_ROWS) -> dict:
    """Convert ``log_paths`` into ``workers`` wire shards and a manifest.

    Returns the aggregate stats (``wire.convert_logs``'s keys plus
    ``workers`` and ``shards``).  Shards land beside ``out_path`` as
    ``<out>.shardKK-of-NN``; ``out_path`` itself becomes the manifest.
    A failed worker aborts the whole convert: the coordinator removes
    every shard before raising, and no manifest is written.
    """
    if workers < 1:
        raise AnalysisError(f"convert fleet needs workers >= 1, got {workers}")
    if not fastparse.available():
        raise NativeParserUnavailable("convert --workers requires the native parser")
    paths = list(log_paths)
    descs = list(_scan_batches(paths, batch_size, 0))
    n_shards = min(workers, max(1, len(descs)))
    spans = [descs[k * len(descs) // n_shards:(k + 1) * len(descs) // n_shards]
             for k in range(n_shards)]
    shard_paths = [_shard_name(out_path, k, n_shards) for k in range(n_shards)]
    per_shard: list[dict | None] = [None] * n_shards
    try:
        if n_shards == 1:
            per_shard[0] = _convert_descs(packed, paths, spans[0], shard_paths[0],
                                          block_rows=block_rows, batch_size=batch_size)
        else:
            _run_fleet(packed, paths, spans, shard_paths, block_rows, batch_size, per_shard)
    except BaseException:
        for sp in shard_paths:
            try:
                os.unlink(sp)
            except OSError:
                pass
        raise

    totals = {key: sum(s[key] for s in per_shard)
              for key in ("rows", "rows6", "raw_lines", "evals", "skipped", "bytes")}
    manifest = {
        "magic": MANIFEST_MAGIC,
        "fingerprint": ruleset_fingerprint(packed).hex(),
        "weighted": True,
        "block_rows": block_rows,
        "batch_size": batch_size,
        "workers": n_shards,
        **totals,
        "shards": per_shard,
    }
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        # no indent: the sniff keys on the first bytes being exactly
        # '{"magic": "RAWIRE-MANIFEST-v1"'
        json.dump(manifest, f)
        f.write("\n")
    os.replace(tmp, out_path)  # atomic: a crashed convert leaves no manifest
    return {
        **totals,
        "parser": f"fleet-x{n_shards}",
        "weighted": True,
        "workers": n_shards,
        "shards": [s["name"] for s in per_shard],
    }
