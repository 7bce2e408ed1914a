"""Live syslog listener tier of the always-on ``serve`` mode.

The port's copy of the reference's ``hostside/listener.py``, whole: the
ingress edge of ``runtime/serve.py``.  Socket listeners (UDP datagrams
and newline-framed TCP, the two shapes syslog relays speak) and a
rotating-file tailer push decoded lines into one bounded
:class:`LineQueue`.  No device work happens here.

Drop accounting is the load-bearing invariant: the queue is bounded, so
a slow consumer costs lines, never unbounded memory, but a line that
cannot be queued is **counted**, and the serve loop stamps every window
that overlaps a drop (or a dead listener) with an explicit
``WindowIncomplete`` marker.  A window that lost lines is never reported
as zero-hit.

Fault sites (runtime/faults.py): ``listener.drop`` drops one received
line (exercising that accounting), ``listener.stall`` wedges a listener
thread mid-receive, ``listener.bind.fail`` fails a socket bind (the
``listener.bind`` retry site waits it out) and ``listener.accept.fail``
throws in a receive loop (the ``listener.accept`` retry site re-enters
it; exhaustion marks the listener dead).

Threads carry the ``ra-`` name prefix, so the tests' leak audit covers
them like every other pipeline thread.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque

from ..errors import AnalysisError
from ..runtime import faults, obs, retrypolicy


class LineQueue:
    """Bounded line queue with explicit, per-cause drop accounting.

    ``put`` never blocks the ingress thread: when the queue is full the
    line is dropped and counted (``dropped``).  Silently blocking a UDP
    receiver would just move the loss into the kernel socket buffer where
    nobody can count it — an explicit host-side counter is the only place
    the "never silently zero-hit" invariant can be enforced from.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise AnalysisError(f"listener queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        #: (line, receipt time.monotonic()) pairs: the receipt stamp is
        #: where the serve tier's ingest->publish latency histogram
        #: starts its clock
        self._q: deque[tuple[str, float]] = deque()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self.received = 0  # lines handed to put() (drops included)
        self.dropped = 0  # lines put() could not queue
        self.forced_drops = 0  # listener.drop fault firings (subset of dropped)

    def put(self, line: str) -> bool:
        t = time.monotonic()
        with self._lock:
            self.received += 1
            if len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append((line, t))
            self._ready.notify()
            return True

    def note_forced_drop(self) -> None:
        """Account a line the ``listener.drop`` fault site discarded."""
        with self._lock:
            self.received += 1
            self.dropped += 1
            self.forced_drops += 1

    def note_discarded(self, n: int = 1) -> None:
        """Account ``n`` lines discarded before they could be queued
        (oversized unterminated frames)."""
        with self._lock:
            self.received += n
            self.dropped += n

    def discard_remaining(self) -> int:
        """Drop-and-count every queued line (bounded shutdown).

        A stop request must not analyze an unbounded backlog, but it
        must never pretend the backlog did not exist: the lines count as
        explicit drops so the final window carries the incomplete marker
        and ``summary.drops`` reports the loss.
        """
        with self._lock:
            n = len(self._q)
            self._q.clear()
            self.dropped += n
            return n

    def pop(self, timeout: float = 0.2) -> str | None:
        got = self.pop_ts(timeout)
        return got[0] if got is not None else None

    def pop_ts(self, timeout: float = 0.2) -> tuple[str, float] | None:
        """Next line WITH its receipt timestamp (``time.monotonic()``)."""
        with self._ready:
            if not self._q:
                self._ready.wait(timeout)
            if not self._q:
                return None
            return self._q.popleft()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "depth": len(self._q),
                "received": self.received,
                "dropped": self.dropped,
                "forced_drops": self.forced_drops,
            }


# longest unterminated line a stream listener will buffer before
# discarding it as a counted drop: the bounded LineQueue is the module's
# memory guarantee, and a peer that never sends a newline must not be
# able to grow a side buffer past it (real syslog lines are < 8 KiB)
MAX_LINE_BYTES = 1 << 20


class BaseListener(threading.Thread):
    """One ingress thread feeding the shared queue.

    Lifecycle: ``start()`` -> receive loop -> ``close()`` (idempotent).
    A listener that dies on an unexpected error records it in ``.error``
    and sets ``.dead`` — the serve loop reads both and decides between
    "mark windows incomplete" and a typed abort.  An injected
    ``listener.stall`` parks the thread until shutdown (or the fault
    plan's disarm) releases it, then terminates it loudly — exactly a
    wedged receiver whose traffic is silently lost upstream.
    """

    kind = "base"

    def __init__(self, q: LineQueue, label: str):
        super().__init__(name=f"ra-listener-{label}", daemon=True)
        self.q = q
        self.label = label
        self.stop_event = threading.Event()
        self.dead = False
        self.error: BaseException | None = None
        #: liveness heartbeat: every receive-loop iteration (idle ones
        #: included) refreshes it, so a thread parked mid-push (injected
        #: listener.stall, frozen socket) is DETECTABLE — the serve loop
        #: compares beat age against the stall timeout instead of
        #: trusting is_alive(), which a wedged thread still satisfies
        self.beat = time.monotonic()

    # -- subclass surface ------------------------------------------------
    def _serve(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _teardown(self) -> None:
        pass

    def _beat(self) -> None:
        """One receive-loop iteration tick: heartbeat + chaos seam.

        The ``listener.accept.fail`` site fires here so transient
        receive-loop faults are injectable in every listener kind; the
        ``listener.accept`` retry policy in :meth:`run` re-enters
        ``_serve`` on them.
        """
        self.beat = time.monotonic()
        faults.fire("listener.accept.fail")

    def _push_all(self, lines: list[str]) -> None:
        """Push a split batch; a fault mid-batch counts the unpushed
        remainder as explicit drops before propagating (the accept
        retry may resume this listener — no silent gap allowed)."""
        for i, line in enumerate(lines):
            try:
                self._push(line)
            except BaseException:
                rest = len(lines) - i - 1
                if rest and not self.stop_event.is_set():
                    self.q.note_discarded(rest)
                raise

    # -- shared line path ------------------------------------------------
    def _push(self, line: str) -> None:
        """Fault-instrumented push: the ONLY way lines enter the queue.

        A fault that escapes mid-push (a released ``listener.stall``, a
        transient burst the accept retry will re-enter around) counts
        its in-flight line as an explicit drop BEFORE propagating — the
        retry policy may resume this listener, and the resumed stream
        must never contain a silent gap.
        """
        try:
            faults.fire("listener.stall", stop=self.stop_event)
            line = faults.fire(
                "listener.drop", payload=line, corrupt=lambda _p, _rng: None
            )
        except BaseException:
            if not self.stop_event.is_set():
                self.q.note_discarded()
                obs.instant(
                    "listener.drop",
                    args={"listener": self.label, "cause": "fault"},
                )
            raise
        if line is None:
            # the site ate the line: account it as an explicit drop so the
            # window it belonged to reports incomplete, never zero-hit
            self.q.note_forced_drop()
            obs.instant("listener.drop", args={"listener": self.label})
            return
        if not self.q.put(line):
            obs.instant("listener.drop", args={"listener": self.label})

    def run(self) -> None:
        try:
            # the receive loop runs under the listener.accept retry
            # policy: a transient fault (classified by errors.is_transient
            # — an injected listener.accept.fail burst, a recoverable
            # socket error) re-enters _serve with seeded backoff instead
            # of killing the listener; exhaustion or a permanent error
            # records it and marks the listener dead — the serve loop's
            # existing escalation (windows incomplete; all-dead aborts
            # typed) takes over from there
            retrypolicy.call("listener.accept", self._serve, stop=self.stop_event)
        except BaseException as e:  # recorded, surfaced by the serve loop
            if not self.stop_event.is_set():
                self.error = e
        finally:
            self.dead = True
            self._teardown()

    def close(self) -> None:
        self.stop_event.set()
        self._teardown()
        if self.ident is not None:  # join() on a never-started thread raises
            self.join(timeout=10.0)


def _bind_retry(sock_type: int, host: str, port: int, finish):
    """Create + bind one socket under the ``listener.bind`` retry policy.

    EADDRINUSE — the TIME_WAIT rebind after a service restart — is the
    canonical transient here; the policy waits it out with seeded
    backoff.  A permanent refusal (EACCES on a privileged port) or an
    exhausted budget escalates the original OSError, which the CLI's
    construction handler reports as the documented clean bind error.
    ``finish`` applies kind-specific setup (listen()) before the socket
    is returned; a failed attempt always closes its socket.
    """

    def _attempt():
        faults.fire("listener.bind.fail")
        s = socket.socket(socket.AF_INET, sock_type)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))
            return finish(s)
        except BaseException:
            s.close()
            raise

    return retrypolicy.call("listener.bind", _attempt)


class UdpSyslogListener(BaseListener):
    """RFC3164-style UDP syslog: one datagram = one log line."""

    kind = "udp"

    def __init__(self, q: LineQueue, host: str, port: int):
        super().__init__(q, f"udp-{host}-{port}")
        self._sock = _bind_retry(
            socket.SOCK_DGRAM, host, port, lambda s: s
        )
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()

    def _serve(self) -> None:
        while not self.stop_event.is_set():
            self._beat()
            try:
                data, _addr = self._sock.recvfrom(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                if self.stop_event.is_set():
                    return
                raise
            # one datagram, one message (trailing newline tolerated)
            self._push(data.decode("utf-8", errors="replace").rstrip("\r\n"))

    def _teardown(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TcpSyslogListener(BaseListener):
    """Newline-framed TCP syslog (the reliable-transport relay shape).

    Single accept loop with short socket timeouts — syslog relays hold
    few long-lived connections, so a select fleet would be overkill; a
    dead peer is detected at the next read.
    """

    kind = "tcp"

    def __init__(self, q: LineQueue, host: str, port: int):
        super().__init__(q, f"tcp-{host}-{port}")
        self._sock = _bind_retry(
            socket.SOCK_STREAM, host, port, lambda s: (s.listen(8), s)[1]
        )
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()
        self._conns: list[socket.socket] = []

    def _serve(self) -> None:
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(self._sock, selectors.EVENT_READ, ("accept", None))
        # partial-frame buffers persist on the instance: a transient
        # receive-loop fault re-enters _serve (listener.accept retry) and
        # must neither drop established connections nor lose their
        # buffered half-lines
        bufs: dict[socket.socket, bytes] = getattr(self, "_bufs", {})
        self._bufs = bufs
        skipping: set[socket.socket] = getattr(self, "_skipping", set())
        self._skipping = skipping
        for conn in self._conns:
            try:
                sel.register(conn, selectors.EVENT_READ, ("conn", None))
                bufs.setdefault(conn, b"")
            except (ValueError, OSError):
                pass  # closed mid-retry; the next recv path cleans up
        try:
            while not self.stop_event.is_set():
                self._beat()
                for key, _ev in sel.select(timeout=0.2):
                    tag, _ = key.data
                    if tag == "accept":
                        try:
                            conn, _addr = self._sock.accept()
                        except OSError:
                            continue
                        conn.setblocking(False)
                        self._conns.append(conn)
                        bufs[conn] = b""
                        sel.register(conn, selectors.EVENT_READ, ("conn", None))
                        continue
                    conn = key.fileobj
                    try:
                        data = conn.recv(1 << 16)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError:
                        data = b""
                    if not data:
                        sel.unregister(conn)
                        skipping.discard(conn)
                        tail = bufs.pop(conn, b"")
                        if tail:  # unterminated final line still counts
                            self._push(tail.decode("utf-8", errors="replace"))
                        try:
                            conn.close()
                        except OSError:
                            pass
                        if conn in self._conns:
                            self._conns.remove(conn)
                        continue
                    if conn in skipping:
                        # inside an oversized (already-dropped) line:
                        # discard until its terminating newline arrives
                        if b"\n" not in data:
                            continue
                        _, data = data.split(b"\n", 1)
                        skipping.discard(conn)
                    buf = bufs[conn] + data
                    *lines, rest = buf.split(b"\n")
                    if len(rest) > MAX_LINE_BYTES:
                        self.q.note_discarded()
                        obs.instant(
                            "listener.drop",
                            args={"listener": self.label, "cause": "oversize"},
                        )
                        rest = b""
                        skipping.add(conn)
                    bufs[conn] = rest
                    self._push_all([
                        raw.decode("utf-8", errors="replace").rstrip("\r")
                        for raw in lines
                    ])
        finally:
            sel.close()

    def _teardown(self) -> None:
        # snapshot: close() runs this on the caller's thread while the
        # receive loop may still be appending/removing connections
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass


class FileTailer(BaseListener):
    """Rotating-file tailer: ``tail -F`` semantics for relay spool files.

    Follows ``path`` from its current end (or the start, for a file that
    appears later), detects rotation by inode change or truncation, and
    re-opens the new file from offset 0 so no post-rotation line is
    missed.  Partial trailing lines wait for their newline.
    """

    kind = "tail"

    def __init__(
        self, q: LineQueue, path: str, poll_sec: float = 0.1,
        from_start: bool = False,
    ):
        super().__init__(q, f"tail-{os.path.basename(path)}")
        self.path = path
        self.poll_sec = poll_sec
        # "pre-existing" is decided HERE, not at the serve thread's first
        # open attempt: a file created between construction and the
        # thread's first poll is NEW traffic and must be read from 0.
        # Deciding it at open time raced exactly that window — whether
        # the first lines survived depended on thread-spawn latency.
        self._from_start = from_start or not os.path.exists(path)

    @staticmethod
    def _ino(f) -> int:
        try:
            return os.fstat(f.fileno()).st_ino
        except OSError:
            return -1

    def _open(self):
        return open(self.path, "r", encoding="utf-8", errors="replace")

    def _serve(self) -> None:
        # Follow state lives on the instance, not in locals: a transient
        # fault re-enters _serve (listener.accept retry) and must resume
        # at the current file offset with its partial line intact — a
        # fresh f=None would reopen at offset 0 (_from_start is True by
        # then) and re-deliver every line already pushed.
        if not hasattr(self, "_f"):
            self._f, self._buf, self._skip = None, "", False
        while not self.stop_event.is_set():
            self._beat()
            if self._f is None:
                try:
                    self._f = self._open()
                except OSError:
                    # a file that appears later is NEW traffic: read it
                    # fully (only an already-present spool skips its past)
                    self._from_start = True
                    self.stop_event.wait(self.poll_sec)
                    continue
                if not self._from_start:
                    self._f.seek(0, os.SEEK_END)
                self._from_start = True  # rotated successors read fully
            chunk = self._f.read(1 << 16)
            if chunk:
                if self._skip:
                    if "\n" not in chunk:
                        continue
                    chunk = chunk.split("\n", 1)[1]
                    self._skip = False
                buf = self._buf + chunk
                *lines, buf = buf.split("\n")
                self._buf = buf
                self._push_all([line.rstrip("\r") for line in lines])
                if len(self._buf) > MAX_LINE_BYTES:
                    self.q.note_discarded()
                    obs.instant(
                        "listener.drop",
                        args={"listener": self.label, "cause": "oversize"},
                    )
                    self._buf = ""
                    self._skip = True
                continue
            # no new data: rotation (new inode) or truncation (shrunk)?
            try:
                st = os.stat(self.path)
                rotated = (
                    st.st_ino != self._ino(self._f)
                    or st.st_size < self._f.tell()
                )
            except OSError:
                rotated = True  # the old file was removed; wait for a new one
            if rotated:
                if self._buf:  # final unterminated line of the old file
                    self._push(self._buf)
                    self._buf = ""
                self._f.close()
                self._f = None
                continue
            self.stop_event.wait(self.poll_sec)
        if self._f is not None:
            self._f.close()
            self._f = None


def parse_listen_spec(spec: str) -> tuple[str, str, int | str]:
    """``udp:HOST:PORT`` / ``tcp:HOST:PORT`` / ``tail:PATH`` -> parts.

    Typed errors (AnalysisError) so the CLI reports a bad ``--listen``
    as usage, not a traceback.
    """
    kind, _, rest = spec.partition(":")
    if kind in ("tail", "tail0"):
        # tail = `tail -F` (skip a pre-existing file's past); tail0 =
        # read a pre-existing file from offset 0, then follow — replays
        # an already-written spool without racing the listener start
        if not rest:
            raise AnalysisError(f"bad --listen {spec!r}: {kind} needs a path")
        return (kind, "", rest)
    if kind in ("udp", "tcp"):
        host, _, port = rest.rpartition(":")
        if not host or not port:
            raise AnalysisError(
                f"bad --listen {spec!r}: want {kind}:HOST:PORT"
            )
        try:
            return (kind, host, int(port))
        except ValueError as e:
            raise AnalysisError(f"bad --listen port in {spec!r}") from e
    raise AnalysisError(
        f"bad --listen {spec!r}: kind must be udp, tcp, tail, or tail0"
    )


def make_listener(q: LineQueue, spec: str) -> BaseListener:
    kind, host, arg = parse_listen_spec(spec)
    if kind == "udp":
        return UdpSyslogListener(q, host, arg)
    if kind == "tcp":
        return TcpSyslogListener(q, host, arg)
    return FileTailer(q, str(arg), from_start=(kind == "tail0"))


def offset_listen_spec(spec: str, rank: int) -> str:
    """Per-host variant of one ``--listen`` spec (distributed serve).

    Each host of a ``serve --distributed`` deployment owns its own
    ingress, so a shared spec must fan out without colliding: fixed
    socket ports offset by ``rank`` (``tcp:H:6514`` -> ``tcp:H:6516``
    on host 2 — the conventional per-member port block), ephemeral
    port 0 stays 0 (every host binds its own, recorded per host in
    ``endpoint.json``), and tail paths gain a ``.host<rank>`` suffix
    (two tailers on one spool would double-count every line).
    Validates via :func:`parse_listen_spec`, so a bad spec fails at
    supervisor construction, not inside the Nth spawned worker.
    """
    kind, host, arg = parse_listen_spec(spec)
    if rank < 0:
        raise AnalysisError(f"listener host rank must be >= 0, got {rank}")
    if kind in ("udp", "tcp"):
        port = int(arg)
        return spec if port == 0 else f"{kind}:{host}:{port + rank}"
    return spec if rank == 0 else f"{kind}:{arg}.host{rank}"


class ListenerSet:
    """The ingress fleet: one queue, N listeners, liveness + gauges."""

    def __init__(self, q: LineQueue, specs: list[str]):
        self.q = q
        self.listeners: list[BaseListener] = []
        try:
            for s in specs:
                self.listeners.append(make_listener(q, s))
        except BaseException:
            # a failing Nth spec must not orphan the N-1 already-bound
            # sockets (the threads never start, so nothing else closes
            # them); close() on an unstarted listener is safe
            self.close()
            raise

    def start(self) -> None:
        for ln in self.listeners:
            ln.start()

    def close(self) -> None:
        for ln in self.listeners:
            ln.close()

    def alive(self) -> int:
        return sum(1 for ln in self.listeners if ln.is_alive() and not ln.dead)

    def stalled(self, age_sec: float) -> list[BaseListener]:
        """Live listeners whose heartbeat is older than ``age_sec``.

        A wedged receiver is worse than a dead one: it still looks alive
        while its traffic silently backs up and drops upstream.  The
        serve loop stamps overlapping windows incomplete and, when EVERY
        live listener is wedged with nothing queued, aborts typed
        (StallError) instead of idling forever.
        """
        now = time.monotonic()
        return [
            ln for ln in self.listeners
            if ln.is_alive() and not ln.dead and now - ln.beat > age_sec
        ]

    def first_error(self) -> BaseException | None:
        for ln in self.listeners:
            if ln.error is not None:
                return ln.error
        return None

    def addresses(self) -> dict[str, list[int | str]]:
        out: dict[str, list] = {}
        for ln in self.listeners:
            addr = getattr(ln, "address", None)
            out[ln.label] = list(addr) if addr else [getattr(ln, "path", "")]
        return out

    def sample_metrics(self) -> dict:
        """Queue/drop gauges for the metrics snapshotter (obs sampler)."""
        return {**self.q.snapshot(), "alive": self.alive(), "n": len(self.listeners)}
