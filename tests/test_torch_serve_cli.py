"""The port's `serve` command line against the reference's.

Both parsers take the same `serve` flags (the port adds `--device`); every
refusal of the reference's `_cmd_serve` gives the same exit code and last
stderr line through the port's; the two modes the port does not serve
yet (`--tenants`, `--distributed`) exit 2 with their own line;
`--autoscale` past the device pool is the reference's refusal; `serve`
over a `tail0:` spool prints the reference's summary and publishes its
window, and with `--epoch-store` writes a store either package folds to
the same registers; and without a card the default `--device cuda` is an
error, never a quiet run on the CPU.
"""

import argparse
import contextlib
import io
import json
import os
import socket
import threading

import pytest
import torch

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack  # noqa: E402
from tests._torch_faultkit import reset_all  # noqa: E402
from tests._torch_servekit import PORT, norm  # noqa: E402
from tests.test_serve import OLD_CFG, _fwx_lines  # noqa: E402


def serve_flags(mod) -> dict:
    ap = mod.make_parser()
    sub = next(a for a in ap._actions if isinstance(a, argparse._SubParsersAction))
    return {opt: (a.dest, a.default, list(a.choices) if a.choices else None, a.nargs,
                  type(a).__name__, a.required)
            for a in sub.choices["serve"]._actions for opt in a.option_strings}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_flag_sets_equal_apart_from_device():
    port, ref = serve_flags(cli), serve_flags(rcli)
    assert port.pop("--device") == ("device", "cuda", ["cuda", "cpu"], None, "_StoreAction",
                                    False)
    assert port == ref


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("tservecli")
    p = str(d / "rules")
    pack.save_packed(PORT.packed(OLD_CFG, "fwx"), p)
    return p


def _call(main, argv):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
    lines = [ln for ln in err.getvalue().splitlines() if ln.strip()]
    return rc, lines[-1] if lines else ""


def _base(prefix, tmp_path):
    return ["serve", "--ruleset", prefix, "--listen", "udp:127.0.0.1:0", "--window",
            "lines:10", "--serve-dir", str(tmp_path / "s")]


#: name -> extra argv (or a function of the base argv): every one a refusal of the
#: reference's, before any serving starts
REFUSALS = {
    "witness budget without --static-analysis": ["--static-witness-budget", "5"],
    "both --ruleset and --tenants": ["--tenants", "m.json"],
    "--dist-hosts without --distributed": ["--dist-hosts", "3"],
    "--dist-respawn without --distributed": ["--dist-respawn"],
    "--dist-spool-dir without --distributed": ["--dist-spool-dir", "x"],
    "--dist-merge-timeout without --distributed": ["--dist-merge-timeout", "5"],
    "a view past the ring": ["--ring", "2", "--view", "3"],
    "an autoscale knob without --autoscale": ["--autoscale-min", "2"],
    "epoch-store budget without the store": ["--epoch-store-budget-mb", "100"],
    "a WAL knob without --wal": ["--wal-segment-kb", "8"],
    "a WAL budget under two segments": ["--wal", "--wal-budget-mb", "1", "--wal-segment-kb",
                                        "1024"],
    "a trend threshold inside the band": ["--trend-threshold", "0.5"],
    "a bad --slo": ["--slo", "bogus"],
    "an unknown fault site": ["--fault-plan", "nosuch@1"],
    "a bad --retry-policy": ["--retry-policy", "zzz"],
    "devprof steps without --devprof-out": ["--devprof-steps", "3"],
    "--blackbox off with a dir": ["--blackbox", "off", "--blackbox-dir", "x"],
    "--autoscale on a hybrid mesh": ["--autoscale", "--mesh", "hybrid"],
    "a zero ring": ["--ring", "0"],
    "a zero queue": ["--queue-lines", "0"],
    "a zero reload poll": ["--reload-poll", "0"],
    "a negative --max-windows": ["--max-windows", "-1"],
}

#: refusals that rewrite the listen/window/ruleset part of the command line
REPLACED = {
    "neither --ruleset nor --tenants": lambda b: b[:1] + b[3:],
    "a bad --listen kind": lambda b: b[:4] + ["smtp:1:2"] + b[5:],
    "a bad --listen port": lambda b: b[:4] + ["udp:h:xx"] + b[5:],
    "a tail without a path": lambda b: b[:4] + ["tail0:"] + b[5:],
    "a bad lines window": lambda b: b[:6] + ["lines:banana"] + b[7:],
    "a bad duration window": lambda b: b[:6] + ["xyz"] + b[7:],
    "a zero lines window": lambda b: b[:6] + ["lines:0"] + b[7:],
    "a zero duration window": lambda b: b[:6] + ["0s"] + b[7:],
    "no --listen": lambda b: b[:3] + b[5:],
    "a missing ruleset": lambda b: b[:2] + [b[2] + "-nope"] + b[3:],
    "--tenants with --autoscale": lambda b: ["serve", "--tenants", "m.json"] + b[3:]
    + ["--autoscale"],
}


@pytest.mark.parametrize("name", sorted(REFUSALS) + sorted(REPLACED))
def test_serve_refusals_match_the_reference(name, prefix, tmp_path):
    base = _base(prefix, tmp_path)
    argv = REPLACED[name](base) if name in REPLACED else base + REFUSALS[name]
    got = _call(cli.main, argv)
    reset_all()
    want = _call(rcli.main, argv)
    reset_all()
    assert got == want
    assert got[0] in (1, 2)


def test_serve_bind_failure_matches_the_reference(prefix, tmp_path):
    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        argv = _base(prefix, tmp_path) + ["--http", f"127.0.0.1:{blocker.getsockname()[1]}"]
        got = _call(cli.main, argv)
        want = _call(rcli.main, argv)
    finally:
        blocker.close()
    assert got == want and got[0] == 2 and "cannot bind --listen/--http" in got[1]


@pytest.mark.parametrize("flags,line", [
    (["--distributed"], "error: serve --distributed is not served by the port yet "
                        "(ROADMAP A10)"),
    (["--tenants", "m.json"], "error: serve --tenants is not served by the port yet "
                              "(ROADMAP A9)"),
])
def test_deferred_modes_exit_2_with_their_own_line(flags, line, prefix, tmp_path):
    argv = _base(prefix, tmp_path) + [f.format(d=tmp_path) for f in flags]
    if "--tenants" in flags:
        argv = argv[:1] + argv[3:]
    assert _call(cli.main, argv) == (2, line)


def test_serve_autoscale_past_the_pool_is_the_reference_refusal(prefix, tmp_path):
    """`--autoscale --autoscale-max 2 --device cpu`: the CPU pool is one
    device, so the port refuses with the reference's line for a maximum past
    its devices (the reference's pool is its eight test devices)."""
    spool = tmp_path / "spool.log"
    spool.write_text("")
    base = ["serve", "--ruleset", prefix, "--listen", f"tail0:{spool}", "--window",
            "lines:10", "--http", "off", "--no-reload-watch", "--autoscale"]
    got = _call(cli.main, base + ["--serve-dir", str(tmp_path / "p"), "--autoscale-max", "2",
                                  "--device", "cpu"])
    reset_all()
    want = _call(rcli.main, base + ["--serve-dir", str(tmp_path / "r"), "--autoscale-max", "9"])
    reset_all()
    assert got == (1, "error: --autoscale-max 2 exceeds the 1 available devices")
    assert want == (1, "error: --autoscale-max 9 exceeds the 8 available devices")


def test_serve_cli_epoch_store_roundtrip(prefix, tmp_path, monkeypatch):
    """`serve --epoch-store DIR` over a tail0 spool: exit 0, the reference's
    summary (the store's path and size apart), and a store each package
    folds to the same registers."""
    from ruleset_analysis_tpu.runtime import epochstore as repochstore
    from ruleset_analysis_tpu_torch.runtime import epochstore

    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))
    spool = tmp_path / "spool.log"
    spool.write_text("\n".join(_fwx_lines(300, seed=3)) + "\n")
    out = {}
    for name, main, extra in (("ref", rcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        argv = ["serve", "--ruleset", prefix, "--listen", f"tail0:{spool}", "--window",
                "lines:100", "--serve-dir", str(tmp_path / name), "--max-windows", "3",
                "--stop-after", "60", "--batch-size", "128", "--http", "off",
                "--no-reload-watch", "--epoch-store", str(tmp_path / f"es-{name}"), *extra]
        buf = io.StringIO()
        reset_all()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        assert rc == 0
        summary = json.loads(buf.getvalue())
        es = summary["epoch_store"]
        assert es.pop("dir") == str(tmp_path / f"es-{name}") and es.pop("bytes") > 0
        out[name] = summary
    reset_all()
    assert norm(out["port"]) == norm(out["ref"])
    assert out["port"]["epoch_store"]["epochs"] == 3
    assert os.path.isdir(tmp_path / "es-port" / "L01")
    port_store = epochstore.EpochStore(str(tmp_path / "es-port"))
    ref_store = repochstore.EpochStore(str(tmp_path / "es-ref"))
    try:
        a, ma = port_store.range_agg(0, 2)
        b, mb = ref_store.range_agg(0, 2)
    finally:
        port_store.close()
        ref_store.close()
    assert ma is None and mb is None
    assert {k: v.tobytes() for k, v in a.arrays.items()} == \
        {k: v.tobytes() for k, v in b.arrays.items()}
    assert a.tables == b.tables and a.summary["lines"] == b.summary["lines"] == 300


def test_serve_default_device_needs_a_card(prefix, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spool = tmp_path / "spool.log"
    spool.write_text("")
    argv = ["serve", "--ruleset", prefix, "--listen", f"tail0:{spool}", "--window",
            "lines:10", "--serve-dir", str(tmp_path / "s"), "--http", "off",
            "--no-reload-watch"]
    rc, last = _call(cli.main, argv)
    assert rc == 1 and "no CUDA device" in last and "--device cpu" in last
    assert not os.path.exists(tmp_path / "s" / "summary.json")


def test_serve_cli_tail_roundtrip(prefix, tmp_path, monkeypatch):
    """`serve` with a tail0 listener replays a pre-written spool, publishes
    a window and the endpoint file, exits on --max-windows, and prints the
    reference's summary."""
    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))
    spool = tmp_path / "spool.log"
    spool.write_text("\n".join(_fwx_lines(100, seed=3)) + "\n")
    out = {}
    for name, main, extra in (("ref", rcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        serve_dir = str(tmp_path / name)
        argv = ["serve", "--ruleset", prefix, "--listen", f"tail0:{spool}", "--window",
                "lines:100", "--serve-dir", serve_dir, "--max-windows", "1", "--stop-after",
                "60", "--batch-size", "128", "--http", "127.0.0.1:0", "--no-reload-watch",
                *extra]
        buf = io.StringIO()
        rc = {}

        def go(main=main, argv=argv, buf=buf, rc=rc):
            with contextlib.redirect_stdout(buf):
                rc["rc"] = main(argv)

        reset_all()
        th = threading.Thread(target=go)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive() and rc["rc"] == 0
        with open(os.path.join(serve_dir, "endpoint.json")) as f:
            ep = json.load(f)
        assert ep["http"] and ep["listeners"]
        with open(os.path.join(serve_dir, "window-000000.json")) as f:
            rep = json.load(f)
        assert rep["totals"]["lines_total"] == 100 and rep["totals"]["window"]["id"] == 0
        out[name] = (json.loads(buf.getvalue()), rep)
    reset_all()
    assert norm(out["port"][0]) == norm(out["ref"][0])
    assert norm(out["port"][1]) == norm(out["ref"][1])
