"""The port's listener tier (hostside/listener.py) against the reference's.

``LineQueue`` drop accounting, every ``parse_listen_spec`` case (each
refusal's words), UDP and TCP round trips, ``tail`` and ``tail0`` across
a rotation, ``offset_listen_spec``, ``ListenerSet``, the forced drop and
stall sites, and the ``listener.bind`` and ``listener.accept`` retry
sites, recovered and exhausted.  No device work is in this module.
"""

import os
import socket
import time

import pytest

pytest.importorskip("jax")

from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.hostside import listener as rlistener  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError, InjectedFault  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import listener  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.listener import (  # noqa: E402
    FileTailer, LineQueue, ListenerSet, TcpSyslogListener, UdpSyslogListener,
    make_listener, offset_listen_spec, parse_listen_spec,
)
from ruleset_analysis_tpu_torch.runtime import faults, retrypolicy  # noqa: E402


def wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def drain(q) -> list:
    out = []
    while True:
        line = q.pop(timeout=0.05)
        if line is None:
            return out
        out.append(line)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    retrypolicy.configure("")
    yield
    faults.disarm()
    retrypolicy.configure("")


# ---------------------------------------------------------------------------
# LineQueue: the bounded queue and its explicit drop accounting.
# ---------------------------------------------------------------------------

#: (operation, argument) sequences run on both packages' queues
QUEUE_SCRIPTS = {
    "overflow": [("put", f"l{i}") for i in range(5)] + [("pop", None)],
    "forced": [("put", "a"), ("forced", None), ("put", "b"), ("pop", None), ("pop", None),
               ("pop", None)],
    "discarded": [("put", "a"), ("discarded", 4), ("put", "b"), ("put", "c"), ("put", "d")],
    "shutdown": [("put", "a"), ("put", "b"), ("discard_remaining", None), ("put", "c"),
                 ("pop", None)],
    "empty_pop": [("pop", None), ("put", "x"), ("pop", None), ("pop", None)],
}


def _play(mod, script):
    q = mod.LineQueue(capacity=3)
    trace = []
    for op, arg in script:
        if op == "put":
            trace.append(q.put(arg))
        elif op == "pop":
            trace.append(q.pop(timeout=0.01))
        elif op == "forced":
            trace.append(q.note_forced_drop())
        elif op == "discarded":
            trace.append(q.note_discarded(arg))
        else:
            trace.append(q.discard_remaining())
        trace.append(len(q))
    return trace, q.snapshot()


@pytest.mark.parametrize("name", sorted(QUEUE_SCRIPTS))
def test_line_queue_matches_the_reference(name):
    assert _play(listener, QUEUE_SCRIPTS[name]) == _play(rlistener, QUEUE_SCRIPTS[name])


def test_line_queue_counts_drops_explicitly():
    q = LineQueue(capacity=3)
    assert all(q.put(f"l{i}") for i in range(3))
    assert not q.put("overflow-1")
    assert not q.put("overflow-2")
    assert q.snapshot() == {"capacity": 3, "depth": 3, "received": 5, "dropped": 2,
                            "forced_drops": 0}
    assert q.pop() == "l0"  # FIFO survives the overflow
    line, t = q.pop_ts()
    assert line == "l1" and t <= time.monotonic()


@pytest.mark.parametrize("capacity", [0, -1])
def test_line_queue_refuses_no_capacity(capacity):
    with pytest.raises(AnalysisError) as a:
        LineQueue(capacity)
    with pytest.raises(RAnalysisError) as b:
        rlistener.LineQueue(capacity)
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# Listen specs.
# ---------------------------------------------------------------------------

SPECS = ["udp:127.0.0.1:514", "tcp:0.0.0.0:6514", "tail:/var/log/asa.log",
         "tail0:/var/log/asa.log", "udp:[::1]:514", "tcp:host:0", "tail:relative/x.log",
         # refusals
         "udp:nohost", "udp:h:xx", "smtp:1:2", "tail:", "tail0:", "tcp::514", "udp",
         "", "tcp:h:"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_listen_spec_matches_the_reference(spec):
    try:
        want = ("ok", rlistener.parse_listen_spec(spec))
    except RAnalysisError as e:
        want = ("refused", str(e))
    try:
        got = ("ok", parse_listen_spec(spec))
    except AnalysisError as e:
        got = ("refused", str(e))
    assert got == want


def test_parse_listen_spec_cases():
    assert parse_listen_spec("udp:127.0.0.1:514") == ("udp", "127.0.0.1", 514)
    assert parse_listen_spec("tail0:/a") == ("tail0", "", "/a")
    for bad in ("udp:nohost", "udp:h:xx", "smtp:1:2", "tail:", "tail0:"):
        with pytest.raises(AnalysisError):
            parse_listen_spec(bad)


OFFSETS = [("tcp:h:6514", 2), ("tcp:h:6514", 0), ("udp:127.0.0.1:0", 3), ("tail:/s.log", 0),
           ("tail:/s.log", 2), ("tail0:/s.log", 1), ("udp:h:514", -1), ("smtp:1:2", 1)]


@pytest.mark.parametrize("spec,rank", OFFSETS)
def test_offset_listen_spec_matches_the_reference(spec, rank):
    try:
        want = ("ok", rlistener.offset_listen_spec(spec, rank))
    except RAnalysisError as e:
        want = ("refused", str(e))
    try:
        got = ("ok", offset_listen_spec(spec, rank))
    except AnalysisError as e:
        got = ("refused", str(e))
    assert got == want


@pytest.mark.parametrize("spec,kind", [("udp:127.0.0.1:0", UdpSyslogListener),
                                       ("tcp:127.0.0.1:0", TcpSyslogListener),
                                       ("tail:{d}/x.log", FileTailer),
                                       ("tail0:{d}/x.log", FileTailer)])
def test_make_listener_kinds(tmp_path, spec, kind):
    ln = make_listener(LineQueue(4), spec.format(d=tmp_path))
    try:
        assert type(ln) is kind and ln.name.startswith("ra-listener-")
        assert ln.kind == {"udp": "udp", "tcp": "tcp"}.get(spec[:3], "tail")
    finally:
        ln.close()


# ---------------------------------------------------------------------------
# Round trips.
# ---------------------------------------------------------------------------


def test_udp_listener_roundtrip():
    q = LineQueue(1024)
    ln = UdpSyslogListener(q, "127.0.0.1", 0)
    ln.start()
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(20):
            s.sendto(f"msg {i}\n".encode(), ln.address)
        s.close()
        wait_for(lambda: q.snapshot()["received"] == 20, msg="udp delivery")
    finally:
        ln.close()
    assert drain(q) == [f"msg {i}" for i in range(20)]
    assert q.snapshot()["dropped"] == 0 and ln.dead


def test_tcp_listener_roundtrip():
    """Newline framing across writes and connections, CRLF stripped, an
    unterminated final line delivered when its peer closes."""
    q = LineQueue(1024)
    ln = TcpSyslogListener(q, "127.0.0.1", 0)
    ln.start()
    try:
        a = socket.create_connection(ln.address)
        a.sendall(b"one\r\ntw")
        time.sleep(0.05)
        a.sendall(b"o\nthree")
        b = socket.create_connection(ln.address)
        b.sendall(b"b1\nb2\n")
        b.close()
        a.close()
        wait_for(lambda: q.snapshot()["received"] == 5, msg="tcp delivery")
    finally:
        ln.close()
    got = drain(q)
    assert sorted(got) == sorted(["one", "two", "three", "b1", "b2"])
    assert got.index("one") < got.index("two") < got.index("three")


def test_tcp_oversized_line_is_a_counted_drop(monkeypatch):
    monkeypatch.setattr(listener, "MAX_LINE_BYTES", 64)
    q = LineQueue(1024)
    ln = TcpSyslogListener(q, "127.0.0.1", 0)
    ln.start()
    try:
        c = socket.create_connection(ln.address)
        c.sendall(b"ok1\n" + b"x" * 200)
        time.sleep(0.05)
        c.sendall(b"yyy\nok2\n")
        c.close()
        wait_for(lambda: q.snapshot()["received"] == 3, msg="delivery")
    finally:
        ln.close()
    assert drain(q) == ["ok1", "ok2"]
    assert q.snapshot()["dropped"] == 1


@pytest.mark.parametrize("kind", ["tail", "tail0"])
def test_file_tailer_follows_rotation(tmp_path, kind):
    """``tail`` skips a spool's past, ``tail0`` reads it from offset 0;
    both follow appends and a rename-and-recreate rotation (no line of the
    new file lost, the old file's unterminated last line delivered)."""
    path = str(tmp_path / "spool.log")
    with open(path, "w") as f:
        f.write("old1\nold2\n")
    q = LineQueue(1024)
    ln = make_listener(q, f"{kind}:{path}")
    ln.poll_sec = 0.02
    ln.start()
    try:
        past = ["old1", "old2"] if kind == "tail0" else []
        wait_for(lambda: ln._f is not None if hasattr(ln, "_f") else False, msg="open")
        wait_for(lambda: q.snapshot()["received"] == len(past), msg="the past")
        with open(path, "a") as f:
            f.write("a1\na2\npartial")
        wait_for(lambda: q.snapshot()["received"] == len(past) + 2, msg="appends")
        os.rename(path, path + ".1")
        with open(path, "w") as f:
            f.write("b1\nb2\nb3\n")
        wait_for(lambda: q.snapshot()["received"] == len(past) + 6, msg="rotation")
    finally:
        ln.close()
    assert drain(q) == past + ["a1", "a2", "partial", "b1", "b2", "b3"]


def test_file_tailer_reads_a_later_file_from_the_start(tmp_path):
    path = str(tmp_path / "later.log")
    q = LineQueue(64)
    ln = FileTailer(q, path, poll_sec=0.02)
    ln.start()
    try:
        with open(path, "w") as f:
            f.write("a1\na2\n")
        wait_for(lambda: q.snapshot()["received"] == 2, msg="new file")
    finally:
        ln.close()
    assert drain(q) == ["a1", "a2"]


# ---------------------------------------------------------------------------
# The set: liveness, addresses, failure cleanup.
# ---------------------------------------------------------------------------


def test_listener_set_liveness_and_addresses(tmp_path):
    q = LineQueue(64)
    ls = ListenerSet(q, ["udp:127.0.0.1:0", f"tail:{tmp_path}/s.log"])
    assert ls.alive() == 0
    ls.start()
    try:
        wait_for(lambda: ls.alive() == 2, msg="alive")
        addrs = ls.addresses()
        assert addrs[f"tail-s.log"] == [f"{tmp_path}/s.log"]
        udp = [v for k, v in addrs.items() if k.startswith("udp-")][0]
        assert udp[0] == "127.0.0.1" and udp[1] > 0
        assert ls.stalled(60.0) == [] and ls.first_error() is None
        assert ls.sample_metrics() == {**q.snapshot(), "alive": 2, "n": 2}
    finally:
        ls.close()
    assert ls.alive() == 0


def test_listener_set_releases_bound_sockets_on_a_bad_spec():
    q = LineQueue(4)
    with pytest.raises(AnalysisError):
        ListenerSet(q, ["tcp:127.0.0.1:0", "smtp:1:2"])


# ---------------------------------------------------------------------------
# Fault sites: forced drop, stall, bind and accept retries.
# ---------------------------------------------------------------------------


def test_forced_drop_is_counted():
    q = LineQueue(64)
    ln = UdpSyslogListener(q, "127.0.0.1", 0)
    with faults.armed(faults.FaultPlan.parse("listener.drop@2")):
        ln.start()
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for i in range(3):
                s.sendto(f"m{i}\n".encode(), ln.address)
                time.sleep(0.02)
            s.close()
            wait_for(lambda: q.snapshot()["received"] == 3, msg="delivery")
        finally:
            ln.close()
    assert drain(q) == ["m0", "m2"]
    snap = q.snapshot()
    assert snap["dropped"] == 1 and snap["forced_drops"] == 1


def test_stalled_listener_is_detected_and_released(tmp_path):
    path = str(tmp_path / "s.log")
    with open(path, "w") as f:
        f.write("a\nb\nc\n")
    q = LineQueue(64)
    ls = ListenerSet(q, [f"tail0:{path}"])
    ln = ls.listeners[0]
    with faults.armed(faults.FaultPlan.parse("listener.stall@2")):
        ls.start()
        try:
            wait_for(lambda: q.snapshot()["received"] == 1, msg="first line")
            wait_for(lambda: ls.stalled(0.2) == [ln], msg="stall detected")
        finally:
            ls.close()
    assert not ln.is_alive() and ln.dead and ln.error is None


def test_listener_bind_transient_recovers_and_exhaustion_typed():
    retrypolicy.configure("listener.bind=4/0.01")
    with faults.armed(faults.FaultPlan.parse("listener.bind.fail@1:2")):
        q = LineQueue(64)
        ln = UdpSyslogListener(q, "127.0.0.1", 0)
        ln.start()
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(b"hello\n", ln.address)
            s.close()
            wait_for(lambda: len(q) > 0, msg="delivery")
            assert q.pop(0.1) == "hello"
        finally:
            ln.close()
    c = retrypolicy.counters()["listener.bind"]
    assert c["recoveries"] >= 1 and c["giveups"] == 0
    # exhaustion: the constructor escalates the typed error (the CLI's
    # clean bind failure)
    with faults.armed(faults.FaultPlan.parse("listener.bind.fail@1:99")):
        with pytest.raises(InjectedFault):
            UdpSyslogListener(LineQueue(64), "127.0.0.1", 0)
    assert retrypolicy.counters()["listener.bind"]["giveups"] == 1


def test_listener_accept_transient_recovers_and_exhaustion_dead():
    retrypolicy.configure("listener.accept=4/0.01")
    with faults.armed(faults.FaultPlan.parse("listener.accept.fail@3:2")):
        q = LineQueue(64)
        ln = UdpSyslogListener(q, "127.0.0.1", 0)
        ln.start()
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for i in range(10):
                s.sendto(f"m{i}\n".encode(), ln.address)
                time.sleep(0.02)
            s.close()
            wait_for(lambda: q.snapshot()["received"] >= 10, 15, "delivery")
            assert ln.is_alive() and not ln.dead
        finally:
            ln.close()
    assert retrypolicy.counters()["listener.accept"]["recoveries"] >= 1
    # exhaustion: the listener dies with the error recorded
    with faults.armed(faults.FaultPlan.parse("listener.accept.fail@1:99")):
        q = LineQueue(64)
        ln = UdpSyslogListener(q, "127.0.0.1", 0)
        ln.start()
        try:
            wait_for(lambda: ln.dead, 15, "dead listener")
            assert isinstance(ln.error, InjectedFault)
        finally:
            ln.close()
