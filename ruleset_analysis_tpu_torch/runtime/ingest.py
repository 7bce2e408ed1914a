"""Pipelined ingest: bounded prefetch of device-ready batches.

A synchronous loop runs host parse, host-to-device copy and device step
one after another, so the run's rate trends toward the SUM of the stage
times.  :class:`PrefetchingSource` decouples them: a producer thread
runs the source's batch iterator (the parse — the native parser
releases the GIL and splits one batch across cores itself), applies a
``pack`` transform (coalescing, wire bit-packing, and the start of the
copy to the card), and feeds a bounded queue that the loop consumes.
The H2D copy of chunk N+k then overlaps the step of chunk N.

On a CUDA device, :class:`H2DRing` gives the copy its own stream: the
producer bit-packs each batch into one of a ring of pinned int32
buffers, copies it with ``non_blocking=True`` on the ring's stream and
records an event; the consumer makes its compute stream wait on that
event and marks the device tensor as used there (``record_stream``), so
the caching allocator does not hand its memory to the side stream while
the step still reads it.  A pinned buffer is refilled only after the
event of its previous copy completed.  A ring feeder batch's per-device
views are bit-packed straight from their shared-memory slots into the
pinned buffer (:func:`views_to_device`), with no assembled host batch
between.  On a CPU device the same classes run without pinned memory or
streams.

Correctness contract — COMMIT AT CONSUME, not at produce:

- Every queue item carries its batch plus the source's cumulative
  parsed/skipped counters captured when the batch was produced, and the
  IPv6 rows the source staged while producing it; the wrapper's public
  ``packer`` counters and its ``take_v6`` advance only when the loop
  receives the batch, so ``totals`` and the v6 chunks follow committed
  batches, exactly as in the synchronous loop.  The same holds for an
  elastic source's per-shard cursors (``cursor_rows``): an epoch
  snapshot names the lines of the last batch the loop consumed, never
  one the producer merely prefetched.
- Batches flow in source order (one producer, a FIFO queue), so every
  batch boundary — and the whole report, per-chunk talker candidates
  included — is identical to the synchronous loop's.
- A producer exception is re-raised, typed, at the consumer's next
  pull; a producer that is alive but hands over nothing for
  ``stall_timeout`` seconds raises :class:`StallError`; ``close()``
  stops and joins the producer thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..errors import AnalysisError, IngestError, StallError
from ..hostside.pack import WIRE_COLS, compact_batch
from . import faults, flightrec, obs, retrypolicy
from .metrics import LatencyHistogram

_END = ("end", None)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A uint32 batch as an int32 CPU tensor holding the same bits.

    Read-only arrays (the wire reader's mmap views) are copied: torch
    must never write through them.
    """
    bits = arr.view(np.int32)
    if not (bits.flags.writeable and bits.flags.c_contiguous):
        bits = np.array(bits, order="C")
    return torch.from_numpy(bits)


class DeviceBatch(NamedTuple):
    """A batch on its device, with the event its copy records (CUDA)."""

    tensor: torch.Tensor
    ready: "torch.cuda.Event | None" = None

    def use(self) -> torch.Tensor:
        """The tensor, safe to read on the consumer's current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.ready)
            self.tensor.record_stream(stream)
        return self.tensor


class H2DRing:
    """Pinned host buffers and a side stream for async copies to the card.

    ``put`` copies a packed uint32 batch into the next pinned buffer of
    the ring (waiting first for that buffer's previous copy), starts its
    copy to ``device`` on the ring's stream, and returns the device
    tensor with the copy's event.  Buffers are (re)allocated per batch
    shape.
    """

    def __init__(self, device: torch.device, n_slots: int):
        if device.type != "cuda":
            raise ValueError(f"H2DRing needs a CUDA device, got {device}")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: list[tuple[torch.Tensor, torch.cuda.Event] | None] = [None] * n_slots
        self._next = 0
        #: bytes copied to the card, and buffers allocated
        self.bytes = 0
        self.allocs = 0

    def _claim(self, shape: tuple[int, ...]) -> tuple[int, torch.Tensor]:
        """The next pinned buffer of ``shape``, once its last copy has left it."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or tuple(slot[0].shape) != shape:
            self.allocs += 1
            return i, torch.empty(shape, dtype=torch.int32, pin_memory=True)
        return i, slot[0]

    def _send(self, i: int, buf: torch.Tensor) -> DeviceBatch:
        """Start buffer ``i``'s copy to the card on the ring's stream."""
        with torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._slots[i] = (buf, ev)
        self.bytes += buf.numel() * 4
        return DeviceBatch(dev, ev)

    def put(self, arr: np.ndarray) -> DeviceBatch:
        i, buf = self._claim(arr.shape)
        np.copyto(buf.numpy(), arr.view(np.int32))
        return self._send(i, buf)

    def put_views(self, views: list[np.ndarray]) -> DeviceBatch:
        """Bit-pack ``[TUPLE_COLS, n]`` views side by side straight into the
        next pinned buffer (no host batch between), and start its copy."""
        i, buf = self._claim((WIRE_COLS, sum(v.shape[1] for v in views)))
        _compact_views(views, buf.numpy().view(np.uint32))
        return self._send(i, buf)


def _compact_views(views: list[np.ndarray], out: np.ndarray) -> None:
    """Each view's wire columns into its own column range of ``out``."""
    col = 0
    for v in views:
        compact_batch(v, out=out[:, col:col + v.shape[1]])
        col += v.shape[1]


def to_device(arr: np.ndarray, device: torch.device, ring: H2DRing | None = None) -> DeviceBatch:
    """A packed uint32 host batch on ``device``: through ``ring`` when given."""
    if ring is not None:
        return ring.put(arr)
    return DeviceBatch(host_tensor(arr).to(device))


def views_to_device(rb, device: torch.device, ring: H2DRing | None = None) -> DeviceBatch:
    """A ring feeder batch (``hostside.feeder._RingBatch``) on ``device``.

    Each device's view is bit-packed straight out of its shared-memory
    slot into the pinned buffer (``ring``).  The copy is one ``device_put``
    retry unit behind the ``stream.device_put.fail`` site, as
    ``mesh.shard_batch`` is: fire, pack, send.  The slots are released
    once, after success or after the retries run out, so a second
    attempt never packs from released slots.
    """

    def _put():
        faults.fire("stream.device_put.fail")
        if ring is not None:
            return ring.put_views(rb.views)
        out = np.empty((WIRE_COLS, sum(v.shape[1] for v in rb.views)), dtype=np.uint32)
        _compact_views(rb.views, out)
        return DeviceBatch(host_tensor(out).to(device))

    try:
        return retrypolicy.call("device_put", _put)
    finally:
        rb.release()


class Counters:
    """A source's cumulative parsed/skipped counters.

    The prefetch wrapper's own copy advances only as batches are
    committed; sources that skip the text parse count in one directly.
    """

    def __init__(self):
        self.parsed = 0
        self.skipped = 0


class IngestStats:
    """Per-stage overlap accounting for one prefetched stream.

    ``produce_sec`` is producer time inside the source iterator plus the
    pack transform (parse, pack, H2D issue); ``backpressure_sec`` is
    producer time blocked on a full queue (the device is the
    bottleneck); ``starved_sec`` is consumer time blocked on an empty
    queue (the host is the bottleneck).
    """

    def __init__(self):
        self.produce_sec = 0.0
        self.backpressure_sec = 0.0
        self.starved_sec = 0.0
        self.batches = 0

    def to_dict(self) -> dict:
        return {
            "batches": self.batches,
            "produce_sec": round(self.produce_sec, 4),
            "backpressure_sec": round(self.backpressure_sec, 4),
            "starved_sec": round(self.starved_sec, 4),
        }


class _Pump:
    """One producer thread filling one bounded queue from one iterator.

    ``with_v6``: pull the source's staged v6 rows after each batch.
    """

    def __init__(self, owner: "PrefetchingSource", it, pack, with_v6: bool):
        self.owner = owner
        self.q: queue.Queue = queue.Queue(maxsize=owner.depth)
        self.stop = threading.Event()
        self._it = it
        self._pack = pack
        self._with_v6 = with_v6
        self.thread = threading.Thread(target=self._produce, name="ra-ingest-producer",
                                       daemon=True)

    def _put(self, item) -> bool:
        """Enqueue, responsive to stop; False if the consumer left."""
        t0 = time.perf_counter()
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                t1 = time.perf_counter()
                self.owner.stats.backpressure_sec += t1 - t0
                if t1 - t0 >= obs.STALL_SPAN_MIN_SEC:
                    # producer blocked on a full queue: the device is the
                    # bottleneck for this interval
                    obs.complete("ingest.backpressure", t0, t1, cat="ingest")
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        owner = self.owner
        packer = owner._inner.packer
        take_v6 = getattr(owner._inner, "take_v6", None) if self._with_v6 else None
        cursor_rows = getattr(owner._inner, "cursor_rows", None)
        try:
            while not self.stop.is_set():
                t0 = time.perf_counter()
                # fault sites: a producer bug (typed at the consumer) and
                # a wedged producer (the consumer's stall watchdog fires)
                faults.fire("ingest.producer.raise")
                faults.fire("ingest.queue.stall", stop=self.stop)
                nxt = next(self._it, None)
                t_parsed = time.perf_counter()
                if nxt is None:
                    break
                batch, n_raw = nxt
                # side effects of producing THIS batch, captured now and
                # committed only when the consumer receives it
                v6 = take_v6() if take_v6 is not None else None
                parsed, skipped = packer.parsed, packer.skipped
                cur = cursor_rows() if cursor_rows is not None else None
                obs.complete("ingest.produce", t0, t_parsed, cat="ingest",
                             args={"n_raw": n_raw})
                if self._pack is not None and batch is not None:
                    batch = self._pack(batch)
                    # bit-pack and the start of the H2D copy
                    obs.complete("ingest.pack", t_parsed, time.perf_counter(), cat="ingest")
                owner.stats.produce_sec += time.perf_counter() - t0
                if not self._put(("item", (batch, n_raw, parsed, skipped, v6, cur, t0))):
                    return
        except BaseException as e:  # re-raised typed at the consumer
            self._put(("error", e))
            return
        self._put(_END)

    def _get_bounded(self):
        """Next queue item, bounded by the stall watchdog.

        Every received item resets the window, so a slow-but-advancing
        producer never trips it.
        """
        timeout = self.owner.stall_timeout
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.q.get(timeout=min(0.2, timeout))
            except queue.Empty:
                if not self.thread.is_alive():
                    raise IngestError("ingest producer thread died without reporting") from None
                if time.monotonic() > deadline:
                    raise StallError(
                        f"ingest producer made no progress in {timeout:g}s "
                        "(queue empty, producer alive); raise --stall-timeout "
                        "if the input is legitimately this slow"
                    ) from None

    def consume(self):
        owner = self.owner
        self.thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                tag, payload = self._get_bounded()
                t1 = time.perf_counter()
                owner.stats.starved_sec += t1 - t0
                if t1 - t0 >= obs.STALL_SPAN_MIN_SEC:
                    # consumer blocked on an empty queue: the host is the
                    # bottleneck for this interval
                    obs.complete("ingest.starved", t0, t1, cat="ingest")
                if tag == "end":
                    return
                if tag == "error":
                    if isinstance(payload, AnalysisError) or not isinstance(payload, Exception):
                        raise payload
                    raise IngestError(
                        f"ingest producer failed: {type(payload).__name__}: {payload}"
                    ) from payload
                batch, n_raw, parsed, skipped, v6, cur, t_prod = payload
                owner.packer.parsed = parsed
                owner.packer.skipped = skipped
                if v6 is not None and len(v6):
                    owner._staged6.append(v6)
                if cur is not None:
                    owner._cursor_rows = cur
                owner.stats.batches += 1
                owner.latency.record(t1 - t_prod)
                # flight-recorder cursors: a dump names the last COMMITTED
                # batch (one dict update when armed)
                flightrec.cursor(committed_batches=owner.stats.batches,
                                 committed_parsed=parsed)
                yield batch, n_raw
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self.stop.set()
        deadline = time.monotonic() + 10.0
        # drain-and-join LOOP: a producer that was mid-put when we drained
        # can enqueue one more item and block again on a full queue
        while self.thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.1)
        if not self.thread.is_alive():
            close_it = getattr(self._it, "close", None)
            if close_it is not None:
                close_it()  # release the iterator's files now, not at GC


class PrefetchingSource:
    """Wrap a stream source with a bounded background prefetch.

    Presents the source protocol the stream loop consumes (``packer``,
    ``set_counts``, ``batches``, and — where the inner source has them —
    ``yields_wire``, ``yields_wire_weighted``, ``totals_patch``, ``close``,
    the IPv6 side channels ``take_v6``, ``batches6``, ``n4_rows``,
    ``v6_digests``, and an elastic source's committed ``cursor_rows``).
    ``pack`` runs in the producer thread on every non-``None`` v4 batch: the loop
    passes the bit-pack and the start of the H2D copy, so queue items are
    device batches.  ``batches6`` (a wire file's v6 section) is pumped
    with no v6 pull and no pack: the loop copies v6 chunks itself.
    """

    def __init__(self, inner, depth: int, pack=None, stall_timeout: float | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._inner = inner
        self.depth = depth
        self._pack = pack
        #: watchdog bound on producer-to-consumer progress (_get_bounded);
        #: unset or <= 0 takes faults.default_stall_timeout (RA_STALL_TIMEOUT)
        self.stall_timeout = (stall_timeout if stall_timeout and stall_timeout > 0
                              else faults.default_stall_timeout())
        self.packer = Counters()
        self.stats = IngestStats()
        #: produce -> commit latency of each batch
        self.latency = LatencyHistogram()
        self._pumps: list[_Pump] = []
        self._staged6: list = []
        self.yields_wire = getattr(inner, "yields_wire", False)
        self.yields_wire_weighted = getattr(inner, "yields_wire_weighted", False)
        # optional protocol members only where the inner source has them:
        # the loop builds its v6 step for sources with take_v6/batches6
        if hasattr(inner, "totals_patch"):
            self.totals_patch = inner.totals_patch
        if hasattr(inner, "take_v6"):
            self.take_v6 = self._take_v6
        if hasattr(inner, "batches6"):
            self.batches6 = self._batches6
        if hasattr(inner, "v6_digests"):
            self.v6_digests = inner.v6_digests
        if hasattr(inner, "cursor_rows"):
            # the cursors of the last COMMITTED batch (the start before any)
            self._cursor_rows = inner.cursor_rows()
            self.cursor_rows = self._committed_cursor_rows
        # the live queue gauges, for the metrics snapshots and crash dumps;
        # unregistered at close
        obs.register_sampler("ingest", self._sample_metrics)

    @property
    def n4_rows(self) -> int:
        return self._inner.n4_rows

    def set_counts(self, parsed: int, skipped: int) -> None:
        """Restore the counters of a resumed run: the inner source's (the
        producer counts on from them) and the committed ones."""
        self._inner.set_counts(parsed, skipped)
        self.packer.parsed, self.packer.skipped = parsed, skipped

    def _take_v6(self):
        """v6 rows of the batches committed since the last call."""
        staged, self._staged6 = self._staged6, []
        if not staged:
            return []
        if len(staged) == 1:
            return staged[0]
        if isinstance(staged[0], np.ndarray):
            return np.concatenate(staged)
        return [row for rows in staged for row in rows]

    def _committed_cursor_rows(self) -> np.ndarray:
        return self._cursor_rows

    def _pump_iter(self, it, pack, with_v6: bool):
        pump = _Pump(self, it, pack, with_v6)
        self._pumps.append(pump)
        return pump.consume()

    def batches(self, skip_lines: int, batch_size: int):
        return self._pump_iter(iter(self._inner.batches(skip_lines, batch_size)),
                               self._pack, with_v6=True)

    def _batches6(self, skip_rows6: int, batch_size: int):
        return self._pump_iter(iter(self._inner.batches6(skip_rows6, batch_size)),
                               None, with_v6=False)

    def ingest_stats(self) -> dict:
        return {"prefetch_depth": self.depth, **self.stats.to_dict()}

    def latency_summary(self) -> dict:
        """Report-facing ``totals.latency`` patch ({} before any batch)."""
        if self.latency.count == 0:
            return {}
        return {"batch_e2e": self.latency.summary()}

    def _sample_metrics(self) -> dict:
        """The bounded queue and the overlap accounting, live."""
        out = {
            "prefetch_depth": self.depth,
            "queue_depth": sum(p.q.qsize() for p in self._pumps),
            "batches": self.stats.batches,
            "produce_sec": round(self.stats.produce_sec, 3),
            "backpressure_sec": round(self.stats.backpressure_sec, 3),
            "starved_sec": round(self.stats.starved_sec, 3),
        }
        if self.latency.count:
            out.update(self.latency.gauges("latency_batch_e2e_"))
        return out

    def close(self) -> None:
        obs.unregister_sampler("ingest")
        for pump in self._pumps:
            pump.shutdown()
        inner_close = getattr(self._inner, "close", None)
        if inner_close is not None:
            inner_close()
