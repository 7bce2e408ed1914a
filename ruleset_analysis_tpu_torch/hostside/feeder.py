"""Multi-worker host feed: parallel parse workers over file shards.

The multi-core input-split tier, one level above the native parser's
in-process threads: N workers each run a :class:`fastparse.NativePacker`
over byte ranges of the input files, and the coordinator hands the
stream loop batches in input order.  Three modes, one descriptor model:

- :class:`ParallelFeeder` (``process``): spawned worker PROCESSES pack
  straight into shared-memory slots; only descriptors and completions
  cross a queue.
- :class:`RingFeeder` (``ring``): one shared-memory ring per device,
  the worker pool partitioned by ring; each device's part of a batch is
  handed over as a view into its ring slot (:class:`_RingBatch`), so
  the loop copies it to the card with no assembled host batch between.
- :class:`ThreadedFeeder` (``thread``): in-process worker THREADS over
  the GIL-releasing native parser; no spawn, no shared memory.

Layout decisions (the reference's):

- The coordinator pre-chops files into descriptors of exactly
  ``batch_size`` raw lines with the native newline scanner: byte ranges
  only, no parsing.  Workers read their range from the file.
- Output slots hold ``rows_cap = 2 x batch_size`` rows when any
  out-direction binding exists (a connection line can emit two
  evaluations), else ``batch_size``.  A descriptor never holds more than
  ``batch_size`` lines, so every line fits: batches follow raw-line
  counts and a dual-evaluation line never closes one early.
- parsed/skipped counters and staged v6 rows ride each completion and
  commit when its batch is YIELDED, in input order, so a snapshot taken
  at a chunk boundary covers exactly the consumed input.

Workers are spawned, not forked: the coordinator holds a CUDA context,
which a forked child must not touch.  A spawned worker imports this
module's package chain, so this module and everything it imports stay
free of ``torch``.  The coordinator builds the native library (under its
build lock) before it starts workers; they only load it.  Every worker
process, ``ra-`` thread and shared-memory segment is gone when
``batches()`` ends, is abandoned, or raises.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue
import time
from multiprocessing import shared_memory

import numpy as np

from ..errors import (
    AnalysisError, FeedWorkerError, NativeParserUnavailable, ResumeInputMismatch, StallError,
)
from ..runtime import faults, flightrec, obs
from . import fastparse
from .pack import TUPLE6_COLS, TUPLE_COLS, PackedRuleset, stage_v6_digests

#: Coordinator read granularity while scanning for batch boundaries.
SCAN_BLOCK = 8 << 20
#: seconds a coordinator waits on the completion queue between liveness probes
POLL_SEC = 5.0


def _scan_batches(paths: list[str], batch_size: int, skip_lines: int):
    """Yield (path_idx, offset, nbytes, n_lines) descriptors.

    Each descriptor covers exactly ``batch_size`` raw lines (the final
    one per file may be short; descriptors never span files).  The first
    ``skip_lines`` lines are consumed without emitting (resume).
    """
    import ctypes

    lib = fastparse._load()
    to_skip = skip_lines
    for path_i, path in enumerate(paths):
        with open(path, "rb") as f:
            buf = b""
            base = 0  # file offset of buf[0]
            pos = 0  # consumed bytes within buf
            eof = False
            pend_lines = 0  # lines in the current (incomplete) descriptor
            pend_start = 0  # absolute file offset where it starts

            def refill():
                nonlocal buf, base, pos, eof
                block = f.read(SCAN_BLOCK)
                if not block:
                    eof = True
                    return
                buf = buf[pos:] + block
                base += pos
                pos = 0

            while True:
                avail = len(buf) - pos
                if avail == 0:
                    if eof:
                        break
                    refill()
                    continue
                want = to_skip if to_skip > 0 else batch_size - pend_lines
                # zero-copy pointer into buf at pos (buf outlives the call)
                arr = np.frombuffer(buf, dtype=np.uint8)
                used = ctypes.c_int64(0)
                got = int(lib.asa_count_lines(
                    ctypes.c_void_p(arr.ctypes.data + pos), avail, 1 if eof else 0, want,
                    ctypes.byref(used),
                ))
                if got == 0:
                    if eof:
                        break
                    refill()  # a line longer than the buffered bytes
                    continue
                if to_skip > 0:
                    to_skip -= got
                    pos += int(used.value)
                    continue
                if pend_lines == 0:
                    pend_start = base + pos
                pend_lines += got
                pos += int(used.value)
                if pend_lines == batch_size:
                    yield (path_i, pend_start, base + pos - pend_start, pend_lines)
                    pend_lines = 0
            if pend_lines:
                yield (path_i, pend_start, base + pos - pend_start, pend_lines)
    if to_skip > 0:
        raise ResumeInputMismatch(
            f"snapshot consumed {skip_lines} lines but the input ran short by {to_skip}"
        )


def _slot_planes(shm, slot_off: int, rows_cap: int, rows6_cap: int):
    """The v4 plane and the v6 plane (None without one) of the slot at byte ``slot_off``."""
    out = np.ndarray((TUPLE_COLS, rows_cap), dtype=np.uint32, buffer=shm.buf, offset=slot_off)
    plane6 = None
    if rows6_cap:
        plane6 = np.ndarray((TUPLE6_COLS, rows6_cap), dtype=np.uint32, buffer=shm.buf,
                            offset=slot_off + 4 * TUPLE_COLS * rows_cap)
    return out, plane6


def _parse_into(packer, files: dict, paths, path_i: int, offset: int, nbytes: int,
                n_lines: int, out: np.ndarray, plane6) -> tuple[int, int, int, int]:
    """Parse one descriptor into a slot's planes: (lines, d_parsed, d_skipped, n6)."""
    f = files.get(path_i)
    if f is None:
        f = files[path_i] = open(paths[path_i], "rb")
    f.seek(offset)
    data = f.read(nbytes)
    p0, s0 = packer.parsed, packer.skipped
    _, lines, _used = packer.pack_chunk(data, out.shape[1], final=True, max_lines=n_lines,
                                        n_threads=1, out=out)
    n6 = 0
    if plane6 is not None:
        # the v6 rows this range staged ride the slot's second plane, in
        # input order; the coordinator commits them when the batch yields
        rows6 = packer.take_v6()
        n6 = len(rows6)
        if n6:
            plane6[:, :n6] = np.asarray(rows6, dtype=np.uint32).T
    return lines, packer.parsed - p0, packer.skipped - s0, n6


def _segment(packed: PackedRuleset, nbytes: int):
    """A new segment: ``nbytes`` of slots, then the pickled ruleset.

    The ruleset reaches spawned workers through the segment, not their
    start arguments: ``Process.start`` blocks until the child has read
    its arguments, which it does only once its interpreter is up, so a
    large argument would start the workers one after another.  Returns
    the segment and ``(offset, length)`` of the ruleset in it.
    """
    blob = pickle.dumps(packed)
    shm = shared_memory.SharedMemory(create=True, size=nbytes + len(blob))
    shm.buf[nbytes:nbytes + len(blob)] = blob
    return shm, (nbytes, len(blob))


def _attach(shm_name: str, blob_at: tuple[int, int]):
    """A worker's view of a :func:`_segment` and the ruleset in it."""
    shm = shared_memory.SharedMemory(name=shm_name)
    off, n = blob_at
    with shm.buf[off:off + n] as blob:
        packed = pickle.loads(blob)
    return shm, packed


def _open_worker(lib_path: str, shm_name: str, blob_at: tuple[int, int]):
    """A spawned worker's packer and its view of the shared slots."""
    fastparse.use_library(lib_path)
    shm, packed = _attach(shm_name, blob_at)
    return fastparse.NativePacker(packed), shm


def _worker(lib_path, shm_name, blob_at, paths, rows_cap, rows6_cap, task_q, done_q):
    """Process-mode worker: descriptors -> shared-memory slots."""
    # the trace shard and the flight ring arm lazily from the inherited
    # RA_TRACE_DIR / RA_BLACKBOX_DIR; the role names this process's track
    obs.note_role("feeder-worker")
    try:
        packer, shm = _open_worker(lib_path, shm_name, blob_at)
    except Exception as e:  # forward instead of dying silently
        done_q.put(("error", -1, f"{type(e).__name__}: {e}"))
        return
    slot_bytes = 4 * (TUPLE_COLS * rows_cap + TUPLE6_COLS * rows6_cap)
    files: dict = {}
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            t0_span = time.perf_counter()
            # fault sites (the plan arrives in the inherited RA_FAULT_PLAN):
            # abrupt death, which the coordinator's liveness probe must
            # catch, and a wedge its stall watchdog must bound
            faults.fire("feeder.worker.crash")
            faults.fire("feeder.worker.stall")
            idx, slot, path_i, offset, nbytes, n_lines = task
            try:
                out, plane6 = _slot_planes(shm, slot * slot_bytes, rows_cap, rows6_cap)
                res = _parse_into(packer, files, paths, path_i, offset, nbytes, n_lines,
                                  out, plane6)
                del out, plane6
            except Exception as e:  # forward instead of dying silently
                done_q.put(("error", idx, f"{type(e).__name__}: {e}"))
                return
            obs.complete("feeder.parse", t0_span, time.perf_counter(), cat="feeder",
                         args={"batch": idx, "lines": res[0]})
            done_q.put((idx, slot, *res))
    finally:
        # seal this worker's flight ring (a no-op disarmed): if the run
        # aborts, the supervising merge reads the survivors' telemetry;
        # a clean run prunes every seal
        flightrec.seal()
        for f in files.values():
            f.close()
        shm.close()


def _stop_processes(workers: list, pill_qs: list, done_q, queues: list) -> None:
    """Bounded teardown: a poison pill into each of ``pill_qs``, ONE shared
    join budget while ``done_q`` is drained (a worker blocked on a full
    pipe cannot exit), terminate and reap stragglers, and close ``queues``
    so their feeder threads do not outlive the run.  After a worker was
    killed there is no join budget: it may have died holding ``done_q``'s
    write lock, and then no sibling's queue thread can flush at exit."""
    for q in pill_qs:
        q.put(None)
    killed = any(w.exitcode not in (None, 0) for w in workers)
    deadline = time.monotonic() + (0.0 if killed else 10.0)
    while any(w.is_alive() for w in workers) and time.monotonic() < deadline:
        try:
            while True:
                done_q.get_nowait()
        except queue.Empty:
            pass
        for w in workers:
            w.join(timeout=0.05)
    for w in workers:
        if w.is_alive():
            w.terminate()
    for w in workers:
        w.join(timeout=5)
    for q in queues:
        q.cancel_join_thread()
        q.close()


def _release_shm(shm) -> None:
    """Close and unlink a coordinator's segment."""
    try:
        shm.close()
    except BufferError:
        # a consumer still holds a view into a slot (an exception unwound
        # mid-pack); the mapping goes with the view, and teardown must not
        # mask the consumer's own error
        pass
    shm.unlink()


class _FeedCounters:
    def __init__(self):
        self.parsed = 0
        self.skipped = 0


class _FeederBase:
    """Source-protocol state the multi-worker feed modes share.

    Every mode commits worker completions in input order: parsed/skipped
    deltas fold into ``.packer`` and v6 rows stage for ``take_v6`` only
    when their batch is YIELDED, so checkpoint snapshots stay coherent
    with consumed input however far the workers ran ahead.
    """

    def __init__(self, packed: PackedRuleset, paths: list[str], n_workers: int,
                 stall_timeout: float | None = None):
        if n_workers < 1:
            raise AnalysisError(f"feeder needs n_workers >= 1, got {n_workers}")
        if not fastparse.available():
            raise NativeParserUnavailable("feeder requires the native parser")
        self.packed = packed
        self.paths = list(paths)
        self.n_workers = n_workers
        #: watchdog bound: workers alive but completing nothing for this
        #: long is a wedge, escalated to a typed StallError abort
        self.stall_timeout = (stall_timeout if stall_timeout and stall_timeout > 0
                              else faults.default_stall_timeout())
        self.packer = _FeedCounters()
        self._resume_counts = (0, 0)
        self._v6chunks: list[np.ndarray] = []  # [n, TUPLE6_COLS] arrays, input order
        #: digest -> 128-bit source for talker rendering (the other sources' contract)
        self.v6_digests: dict[int, int] = {}

    def set_counts(self, parsed: int, skipped: int) -> None:
        self._resume_counts = (parsed, skipped)

    def take_v6(self):
        """Staged v6 rows as one ``[n, TUPLE6_COLS]`` array (or [] when none)."""
        chunks, self._v6chunks = self._v6chunks, []
        if not chunks:
            return []
        if len(chunks) == 1:
            return chunks[0]
        return np.concatenate(chunks)

    def _stage_v6(self, rows6: np.ndarray) -> None:
        """Commit one batch's v6 rows and talker digests, in input order."""
        stage_v6_digests(rows6, self.v6_digests)
        self._v6chunks.append(rows6)

    def _spawn(self, target, shm, blob_at, args_of, n: int, into: list) -> None:
        """Start ``n`` spawned workers ``target(lib, shm name, blob_at, paths,
        *args_of(i))`` into ``into``; the library is built here, before any
        worker starts."""
        lib = str(fastparse.build())
        ctx = multiprocessing.get_context("spawn")
        for i in range(n):
            p = ctx.Process(target=target,
                            args=(lib, shm.name, blob_at, self.paths, *args_of(i)),
                            daemon=True)
            p.start()
            into.append(p)
        self._workers = into  # the killed-worker tests reach them here

    def _no_progress(self, workers: list, deadline: float, what: str) -> None:
        """After a quiet poll: a dead worker or a passed stall deadline raises."""
        dead = [w.pid for w in workers if not w.is_alive()]
        if dead:
            raise FeedWorkerError(
                f"{what} worker(s) {dead} died without reporting (killed by the OS?)"
            )
        if time.monotonic() > deadline:
            raise StallError(
                f"{what} workers made no progress in {self.stall_timeout:.0f}s "
                f"({len(workers)} alive); raise --stall-timeout if the input is "
                "legitimately this slow"
            )


class ParallelFeeder(_FeederBase):
    """Stream source over files backed by N parse worker processes.

    ``.batches(skip_lines, batch_size)`` yields ``([TUPLE_COLS, rows_cap]
    uint32, raw_line_count)`` in input order; ``rows_cap`` is fixed per
    run (2 x batch_size with out-bindings).
    """

    def batches(self, skip_lines: int, batch_size: int):
        self.packer.parsed, self.packer.skipped = self._resume_counts
        rows_cap = (2 if self.packed.bindings_out else 1) * batch_size
        # v6 plane: any line of a batch can be a dual-evaluation v6 line
        rows6_cap = 2 * batch_size if self.packed.has_v6 else 0
        n_slots = 2 * self.n_workers + 2
        slot_bytes = 4 * (TUPLE_COLS * rows_cap + TUPLE6_COLS * rows6_cap)
        shm, blob_at = _segment(self.packed, n_slots * slot_bytes)
        ctx = multiprocessing.get_context("spawn")
        task_q, done_q = ctx.Queue(), ctx.Queue()
        workers = []
        try:
            self._spawn(_worker, shm, blob_at, lambda i: (rows_cap, rows6_cap, task_q, done_q),
                        self.n_workers, workers)
            free_slots = list(range(n_slots))
            ready: dict[int, tuple] = {}  # idx -> completion
            next_submit = 0
            next_yield = 0
            desc_it = _scan_batches(self.paths, batch_size, skip_lines)
            descs_done = False

            def submit_until_full():
                nonlocal next_submit, descs_done
                while free_slots and not descs_done:
                    d = next(desc_it, None)
                    if d is None:
                        descs_done = True
                        break
                    task_q.put((next_submit, free_slots.pop(), *d))
                    next_submit += 1

            def _occupancy() -> dict:
                # the pool: descriptors in flight against workers alive
                return {
                    "mode": "process",
                    "workers": len(workers),
                    "alive": sum(1 for w in workers if w.is_alive()),
                    "inflight": next_submit - next_yield,
                    "ready": len(ready),
                    "free_slots": len(free_slots),
                }

            obs.register_sampler("feeder", _occupancy)
            submit_until_full()
            stall_deadline = time.monotonic() + self.stall_timeout
            while next_yield < next_submit:
                while next_yield not in ready:
                    # timeout + liveness: a worker the OS killed cannot
                    # forward its error, and waiting forever on its
                    # completion would hang the run silently
                    try:
                        msg = done_q.get(timeout=POLL_SEC)
                    except queue.Empty:
                        self._no_progress(workers, stall_deadline, "feeder")
                        continue
                    stall_deadline = time.monotonic() + self.stall_timeout
                    if msg[0] == "error":
                        raise FeedWorkerError(f"feeder worker failed on batch {msg[1]}: {msg[2]}")
                    ready[msg[0]] = msg[1:]
                slot, lines, dp, ds, n6 = ready.pop(next_yield)
                out, plane6 = _slot_planes(shm, slot * slot_bytes, rows_cap, rows6_cap)
                batch = out.copy()  # the slot is reused; the loop may hold the batch
                if n6:
                    self._stage_v6(np.ascontiguousarray(plane6[:, :n6].T))
                del out, plane6
                free_slots.append(slot)
                next_yield += 1
                self.packer.parsed += dp
                self.packer.skipped += ds
                submit_until_full()
                yield batch, lines
        finally:
            obs.unregister_sampler("feeder")
            _stop_processes(workers, [task_q] * len(workers), done_q, [task_q, done_q])
            # drop the queues now: an exception's traceback keeps this frame,
            # and their finalizers must not run later at an arbitrary point
            workers.clear()
            task_q = done_q = None
            _release_shm(shm)


def _ring_worker(lib_path, shm_name, blob_at, paths, rows_cap_shard, rows6_cap_shard,
                 ring_depth, task_q, done_q):
    """Ring-mode worker: fine descriptors -> per-ring slots.

    Each task names the ring and slot its output belongs to; one worker
    may serve several rings (W < D) or share a ring with siblings
    (W > D), and the coordinator's routing keeps every ring's slots
    written in group order either way.
    """
    obs.note_role("ring-worker")
    try:
        packer, shm = _open_worker(lib_path, shm_name, blob_at)
    except Exception as e:  # forward instead of dying silently
        done_q.put(("error", -1, f"{type(e).__name__}: {e}"))
        return
    slot_bytes = 4 * (TUPLE_COLS * rows_cap_shard + TUPLE6_COLS * rows6_cap_shard)
    files: dict = {}
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            t0_span = time.perf_counter()
            # the process worker's sites, plus the ring's own stall: a
            # wedged partition producer starves exactly one device
            faults.fire("feeder.worker.crash")
            faults.fire("feeder.ring.stall")
            g, j, slot, path_i, offset, nbytes, n_lines = task
            try:
                out, plane6 = _slot_planes(shm, (j * ring_depth + slot) * slot_bytes,
                                           rows_cap_shard, rows6_cap_shard)
                res = _parse_into(packer, files, paths, path_i, offset, nbytes, n_lines,
                                  out, plane6)
                del out, plane6
            except Exception as e:  # forward instead of dying silently
                done_q.put(("error", g, f"{type(e).__name__}: {e}"))
                return
            obs.complete("feeder.parse", t0_span, time.perf_counter(), cat="feeder",
                         args={"group": g, "ring": j, "lines": res[0]})
            done_q.put((g, j, slot, *res))
    finally:
        flightrec.seal()  # the worker-exit seal, as in _worker
        for f in files.values():
            f.close()
        shm.close()


class _RingBatch:
    """One committed group: per-ring views of ring slots.

    ``views[d]`` is ring d's ``[TUPLE_COLS, shard_rows]`` plane, a view
    straight into its shared-memory slot.  The consumer calls
    :meth:`release` once it has copied the data out;
    :meth:`assemble` copies into one plain batch and releases.
    """

    __slots__ = ("views", "n_raw", "_release_cb", "released")

    def __init__(self, views, n_raw, release_cb):
        self.views = views
        self.n_raw = n_raw
        self._release_cb = release_cb
        self.released = False

    def release(self) -> None:
        if not self.released:
            self.released = True
            self.views = []  # no view outlives its slot's reuse
            self._release_cb()

    def assemble(self) -> np.ndarray:
        """One ``[TUPLE_COLS, D * shard_rows]`` batch (copies, then releases)."""
        out = np.concatenate(self.views, axis=1)
        self.release()
        return out


class RingFeeder(_FeederBase):
    """One shared-memory ring per device, the worker pool partitioned by ring.

    Descriptors chop ``batch_size / D`` lines fine, so a group of D
    consecutive descriptors covers exactly the lines a process-mode
    batch with the same index covers (groups reset at file boundaries as
    batches do); ring d's workers parse sub-range d straight into d's
    slots.  Every register update is order- and padding-invariant and v6
    rows commit in line order, so reports equal the process mode's.

    ``emit_views`` (set by the loop): True yields :class:`_RingBatch`
    views for the direct copy to the card (prefetch on); False yields
    assembled ``[TUPLE_COLS, rows_cap]`` arrays (the synchronous loop).
    ``n_rings`` None resolves to 1 (the loop sets the device count).
    """

    yields_ring = True

    def __init__(self, packed: PackedRuleset, paths: list[str], n_workers: int,
                 stall_timeout: float | None = None, n_rings: int | None = None,
                 ring_depth: int = 4):
        super().__init__(packed, paths, n_workers, stall_timeout)
        self.n_rings = n_rings
        self.ring_depth = max(2, ring_depth)
        self.emit_views = False
        #: per-ring seconds the coordinator waited on that ring's shard, and
        #: per-ring slots in flight: the ring gauges, read live by the
        #: ``feeder`` metrics sampler and summed into the ``feeder.summary``
        #: trace instant (the workers are processes of their own, outside
        #: this registry: the parent reads their rings' gauges)
        self._starved_sec: list[float] = []
        self._occupancy: list[int] = []

    def batches(self, skip_lines: int, batch_size: int):
        self.packer.parsed, self.packer.skipped = self._resume_counts
        D = int(self.n_rings or 1)
        if batch_size % D:
            raise AnalysisError(
                f"ring feeder needs batch_size divisible by the ring count "
                f"({batch_size} % {D} != 0); pad the batch size"
            )
        sub = batch_size // D
        rows_cap_shard = (2 if self.packed.bindings_out else 1) * sub
        rows6_cap_shard = 2 * sub if self.packed.has_v6 else 0
        R = self.ring_depth
        W = self.n_workers
        slot_bytes = 4 * (TUPLE_COLS * rows_cap_shard + TUPLE6_COLS * rows6_cap_shard)
        shm, blob_at = _segment(self.packed, D * R * slot_bytes)
        ctx = multiprocessing.get_context("spawn")
        # one worker partition per ring: contiguous ring blocks when W < D,
        # the residue class w = d (mod D) when W >= D
        if W >= D:
            ring_workers = [[w for w in range(W) if w % D == d] for d in range(D)]
        else:
            ring_workers = [[d * W // D] for d in range(D)]
        used = sorted({w for ws in ring_workers for w in ws})
        task_qs = {w: ctx.Queue() for w in used}
        done_q = ctx.Queue()
        workers = []
        self._starved_sec = [0.0] * D
        self._occupancy = [0] * D
        occ_integral = [0.0] * D  # slot-seconds held a ring, for feeder.summary
        next_submit = next_yield = 0
        t_feed0 = None
        try:
            self._spawn(_ring_worker, shm, blob_at,
                        lambda i: (rows_cap_shard, rows6_cap_shard, R, task_qs[used[i]],
                                   done_q),
                        len(used), workers)
            free_slots = [list(range(R)) for _ in range(D)]
            # meta[g] = (n_shards, n_raw); done[g] = {j: (slot, lines, dp, ds, n6)}
            meta: dict[int, tuple[int, int]] = {}
            done: dict[int, dict[int, tuple]] = {}

            def group_it():
                """Groups of <= D fine descriptors, reset at file boundaries."""
                cur: list[tuple] = []
                for d in _scan_batches(self.paths, sub, skip_lines):
                    if cur and (d[0] != cur[0][0] or len(cur) == D):
                        yield cur
                        cur = []
                    cur.append(d)
                    if d[3] < sub:  # a short descriptor: the file ends here
                        yield cur
                        cur = []
                if cur:
                    yield cur

            groups = group_it()
            groups_done = False

            def submit_until_full():
                # a group submits only when EVERY ring has a free slot, so
                # each ring's submission order is the group order
                nonlocal next_submit, groups_done
                while not groups_done:
                    if any(not free_slots[j] for j in range(D)):
                        return
                    grp = next(groups, None)
                    if grp is None:
                        groups_done = True
                        return
                    g = next_submit
                    next_submit += 1
                    meta[g] = (len(grp), sum(d[3] for d in grp))
                    done[g] = {}
                    for j, desc in enumerate(grp):
                        self._occupancy[j] += 1
                        ws = ring_workers[j]
                        task_qs[ws[g % len(ws)]].put((g, j, free_slots[j].pop(), *desc))

            def _gauges() -> dict:
                occ = list(self._occupancy)
                return {
                    "mode": "ring",
                    "rings": D,
                    "ring_depth": R,
                    "workers": len(workers),
                    "alive": sum(1 for w in workers if w.is_alive()),
                    "inflight": next_submit - next_yield,
                    "ring_occupancy": occ,
                    "partition_imbalance": max(occ) - min(occ) if occ else 0,
                    "starved_sec": [round(s, 3) for s in self._starved_sec],
                }

            obs.register_sampler("feeder", _gauges)
            submit_until_full()
            t_feed0 = t_occ = time.monotonic()  # the occupancy integral starts here
            stall_deadline = time.monotonic() + self.stall_timeout
            while True:
                if next_yield == next_submit:
                    if groups_done:
                        break
                    # input remains but nothing could submit: the consumer
                    # holds every slot of some ring, and it releases only
                    # between pulls, so abort loudly rather than truncate
                    raise FeedWorkerError(
                        "ring slots exhausted with unparsed input left: the consumer "
                        "holds batches for every slot of a ring; release each batch "
                        "before pulling the next (or raise ring_depth)"
                    )
                n_shards, n_raw = meta[next_yield]
                while len(done[next_yield]) < n_shards:
                    pending = [j for j in range(n_shards) if j not in done[next_yield]]
                    t0 = time.monotonic()
                    try:
                        msg = done_q.get(timeout=POLL_SEC)
                    except queue.Empty:
                        for j in pending:
                            self._starved_sec[j] += time.monotonic() - t0
                        self._no_progress(workers, stall_deadline, "ring feed")
                        continue
                    now = time.monotonic()
                    for j in pending:
                        self._starved_sec[j] += now - t0
                    for j in range(D):
                        occ_integral[j] += self._occupancy[j] * (now - t_occ)
                    t_occ = now
                    stall_deadline = time.monotonic() + self.stall_timeout
                    if msg[0] == "error":
                        raise FeedWorkerError(
                            f"ring feed worker failed on group {msg[1]}: {msg[2]}"
                        )
                    g, j, *rest = msg
                    done[g][j] = rest
                shards = done.pop(next_yield)
                del meta[next_yield]
                views = []
                taken: list[tuple[int, int]] = []  # (ring, slot) to free
                for j in range(n_shards):
                    slot, lines, dp, ds, n6 = shards[j]
                    out, plane6 = _slot_planes(shm, (j * R + slot) * slot_bytes,
                                               rows_cap_shard, rows6_cap_shard)
                    views.append(out)
                    if n6:
                        # committed in shard (= line) order, the process mode's stream
                        self._stage_v6(np.ascontiguousarray(plane6[:, :n6].T))
                    del out, plane6
                    self.packer.parsed += dp
                    self.packer.skipped += ds
                    taken.append((j, slot))
                for _ in range(n_shards, D):
                    # a short group (file end): the missing rings feed
                    # valid = 0 padding, masked on the card like any other
                    views.append(np.zeros((TUPLE_COLS, rows_cap_shard), dtype=np.uint32))

                def release(taken=taken):
                    for j, slot in taken:
                        free_slots[j].append(slot)
                        self._occupancy[j] -= 1

                rb = _RingBatch(views, n_raw, release)
                del views
                next_yield += 1
                if not self.emit_views:
                    out = rb.assemble()  # copies and releases before the yield
                    submit_until_full()
                    yield out, n_raw
                else:
                    yield rb, n_raw
                    # the consumer released while packing (same thread);
                    # anything still held waits another round
                    submit_until_full()
                del rb
        finally:
            obs.unregister_sampler("feeder")
            if next_submit and t_feed0 is not None:
                # one summary instant on the trace timeline
                elapsed = max(1e-9, time.monotonic() - t_feed0)
                occ_pct = [round(100.0 * occ_integral[j] / (R * elapsed), 2) for j in range(D)]
                obs.instant("feeder.summary", args={
                    "mode": "ring", "rings": D, "ring_depth": R, "workers": len(workers),
                    "groups": next_yield, "ring_occupancy_pct": occ_pct,
                    "partition_imbalance_pct": round(max(occ_pct) - min(occ_pct), 2),
                    "starved_sec": [round(x, 3) for x in self._starved_sec],
                    "starved_total_sec": round(sum(self._starved_sec), 3),
                })
            _stop_processes(workers, list(task_qs.values()), done_q,
                            [*task_qs.values(), done_q])
            workers.clear()  # as in ParallelFeeder.batches
            task_qs.clear()
            done_q = None
            _release_shm(shm)


class ThreadedFeeder(_FeederBase):
    """In-process threaded twin of :class:`ParallelFeeder`.

    Worker THREADS parse the same exact-raw-line descriptors; the native
    parser releases the GIL for the parse, so threads scale across cores
    with no spawn, no pickling and no shared memory.  Each thread builds
    one NativePacker lazily and reuses it; completions commit strictly
    in input order, so batch boundaries equal the process mode's.
    """

    def batches(self, skip_lines: int, batch_size: int):
        import concurrent.futures as cf
        import threading
        from collections import deque

        self.packer.parsed, self.packer.skipped = self._resume_counts
        rows_cap = (2 if self.packed.bindings_out else 1) * batch_size
        has_v6 = self.packed.has_v6
        tl = threading.local()
        # every handle any worker opens, closed in the finally below
        # (thread-local GC alone would hold them past an early exit)
        files_lock = threading.Lock()
        opened: list = []
        stop_ev = threading.Event()  # releases injected stalls at teardown

        def work(desc):
            t0_span = time.perf_counter()
            # the thread twin of the process worker's sites (no crash
            # site: os._exit here would take the run down)
            faults.fire("feeder.worker.stall", stop=stop_ev)
            path_i, offset, nbytes, n_lines = desc
            pk = getattr(tl, "packer", None)
            if pk is None:
                pk = tl.packer = fastparse.NativePacker(self.packed)
                tl.files = {}
            f = tl.files.get(path_i)
            if f is None:
                f = tl.files[path_i] = open(self.paths[path_i], "rb")
                with files_lock:
                    opened.append(f)
            f.seek(offset)
            data = f.read(nbytes)
            p0, s0 = pk.parsed, pk.skipped
            batch, lines, _used = pk.pack_chunk(data, rows_cap, final=True, max_lines=n_lines,
                                                n_threads=1)
            rows6 = pk.take_v6() if has_v6 else []
            obs.complete("feeder.parse", t0_span, time.perf_counter(), cat="feeder",
                         args={"lines": lines})
            return batch, lines, pk.parsed - p0, pk.skipped - s0, rows6

        desc_it = _scan_batches(self.paths, batch_size, skip_lines)
        ex = cf.ThreadPoolExecutor(max_workers=self.n_workers, thread_name_prefix="ra-feed")
        inflight: deque = deque()
        max_inflight = 2 * self.n_workers + 2
        stalled = False
        try:
            obs.register_sampler("feeder", lambda: {
                "mode": "thread", "workers": self.n_workers, "inflight": len(inflight),
            })

            def fill() -> None:
                while len(inflight) < max_inflight:
                    d = next(desc_it, None)
                    if d is None:
                        return
                    inflight.append(ex.submit(work, d))

            fill()
            while inflight:
                fut = inflight.popleft()
                try:
                    # the batches commit in submission order, so waiting on
                    # THIS future is exactly producer-to-consumer progress
                    batch, lines, dp, ds, rows6 = fut.result(timeout=self.stall_timeout)
                except cf.TimeoutError:
                    stalled = True
                    raise StallError(
                        f"feed worker made no progress in {self.stall_timeout:.0f}s; raise "
                        "--stall-timeout if the input is legitimately this slow"
                    ) from None
                except Exception as e:
                    raise FeedWorkerError(f"feed worker failed: {type(e).__name__}: {e}") from e
                self.packer.parsed += dp
                self.packer.skipped += ds
                if len(rows6):
                    self._stage_v6(np.asarray(rows6, dtype=np.uint32))
                fill()
                yield batch, lines
        finally:
            obs.unregister_sampler("feeder")
            # release injected stalls first, so the shutdown below cannot
            # wedge on a thread parked in a fault site; a worker
            # mid-descriptor finishes before its files close under it,
            # except after a stall verdict: a thread wedged in an OS call
            # cannot be cancelled, and waiting on it would turn the typed
            # StallError into a hang
            stop_ev.set()
            ex.shutdown(wait=not stalled, cancel_futures=True)
            with files_lock:
                for f in opened:
                    f.close()
