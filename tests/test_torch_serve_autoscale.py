"""Serve's autoscaler in the port against the reference.

Counterparts of the serve cases of ``tests/test_autoscale.py``:

- every refusal of ``test_serve_autoscale_rejects_bad_geometry`` (a hybrid
  mesh, an explicit mesh, an initial world off the ladder, more worlds
  than devices), with the reference's messages, and the CPU's default
  pool of one device;
- ``test_chaos_autoscale_seam`` with the same six seeds: a fault at the
  decide or spawn seam aborts typed in both packages, a schedule that
  never fires leaves every window bit-identical to an offline replay;
- the end-to-end case, made deterministic: the scale events come from
  the scripted plan (``AutoscaleConfig.plan``) and the ``tail0:`` spool
  grows only once each event has been applied, so windows straddle both
  events.  Each window equals the reference's offline fixed-world
  ``run_stream`` of its lines and the port's own, and the two packages
  publish the same windows;
- the signal-driven burst out and idle in, on the port alone, with its
  own time limit: a burst deep enough that the queue stays above the
  pressure threshold for the whole sustain window, then the idle queue.

The port's worlds are drawn from a pool of eight shards of the CPU
(``devices=[cpu] * 8``), the reference's from its tests' eight fake
devices.  Every case joins its serve thread (``serve_run``) before it
returns.
"""

import json

import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu.config import AutoscaleConfig as RAutoscaleConfig  # noqa: E402
from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu_torch.config import AutoscaleConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.autoscale import world_ladder  # noqa: E402
from tests._torch_servekit import (  # noqa: E402
    PORT, REF, SIDES, norm, serve_run, wait_for, write_lines,
)
from tests.test_autoscale import chaos_schedule  # noqa: E402

#: the reference suite's serve config (its SERVE_CFG)
SERVE_CFG = dict(batch_size=64, sketch=dict(cms_width=1 << 10, cms_depth=2, hll_p=6))
#: the port's device pool: eight shards of the CPU
POOL = [torch.device("cpu")] * 8
CHAOS_W = 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def acfg(side, **kw):
    """The reference suite's autoscale config for ``side``."""
    base = dict(min_world=1, max_world=8, out_threshold=0.5, in_threshold=0.8,
                sustain_sec=1.0, cooldown_sec=2.0, reform_budget=4, poll_sec=0.1)
    base.update(kw)
    return (AutoscaleConfig if side is PORT else RAutoscaleConfig)(**base)


def drv_kw(side, a) -> dict:
    """The driver keywords of an autoscaled run: no mesh, the pool."""
    if side is PORT:
        return {"ascfg": a, "devices": POOL, "topk": 5}
    return {"ascfg": a, "mesh": None, "topk": 5}


@pytest.fixture(scope="module")
def serve_corpus(tmp_path_factory):
    """The reference suite's corpus: 2 ACLs x 8 rules, 3000 lines."""
    td = tmp_path_factory.mktemp("tas_serve")
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=0)
    packed = PORT.packed(cfg_text, "fw1")
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 3000, seed=1), seed=1)
    return {"prefix": prefix, "lines": lines, "packed": packed,
            "rpacked": REF.packed(cfg_text, "fw1")}


def image(rep) -> dict:
    """A window report without volatile totals, the backend and the window
    block (the offline replay has none)."""
    j = norm(rep if isinstance(rep, dict) else json.loads(rep.to_json()))
    j["totals"].pop("window", None)
    return j


def offline(side, c, seg) -> dict:
    packed = c["packed"] if side is PORT else c["rpacked"]
    return image(side.run_stream(packed, seg, side.cfg(**SERVE_CFG), topk=5))


def scfg_of(side, d, **kw):
    base = dict(listen=(f"tail0:{d / 'spool.log'}",), ring=4, serve_dir=str(d / "serve"),
                http="off", queue_lines=10_000, reload_watch=False, stop_after_sec=90,
                checkpoint_every_windows=0)
    base.update(kw)
    return side.scfg(**base)


# ---------------------------------------------------------------------------
# The refusals.
# ---------------------------------------------------------------------------


def test_serve_autoscale_rejects_bad_geometry(serve_corpus, tmp_path):
    prefix = serve_corpus["prefix"]
    msgs = {}
    for side, err in ((REF, RAnalysisError), (PORT, AnalysisError)):
        scfg = side.scfg(listen=("tcp:127.0.0.1:0",), window_lines=100,
                         serve_dir=str(tmp_path / side.name), http="off", reload_watch=False)
        got = []
        # the hybrid topology is the multi-host direction; serve autoscale
        # resizes a flat mesh
        with pytest.raises(err, match="hybrid") as e:
            side.serve.ServeDriver(prefix, side.cfg(**SERVE_CFG, mesh_shape="hybrid"), scfg,
                                   ascfg=acfg(side))
        got.append(str(e.value))
        # an explicit mesh cannot be resized
        mesh = mesh_lib.make_mesh(POOL[:2]) if side is PORT else rmesh.make_mesh()
        with pytest.raises(err, match="owns the mesh") as e:
            side.serve.ServeDriver(prefix, side.cfg(**SERVE_CFG), scfg, mesh=mesh,
                                   ascfg=acfg(side))
        got.append(str(e.value))
        # an initial world off the ladder (3 does not divide 8), and more
        # worlds than devices: refused when the run starts, sockets released
        for a, match in ((acfg(side, min_world=1, max_world=8, initial_world=3), "ladder"),
                         (acfg(side, max_world=64), "devices")):
            drv = side.serve.ServeDriver(prefix, side.cfg(**SERVE_CFG), scfg,
                                         **{k: v for k, v in drv_kw(side, a).items()
                                            if k != "topk"})
            with pytest.raises(err, match=match) as e:
                drv.run()
            got.append(str(e.value))
            assert drv.listeners.alive() == 0
        msgs[side.name] = got
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"][-1] == "--autoscale-max 64 exceeds the 8 available devices"
    # the CPU's default pool is one device
    scfg = PORT.scfg(listen=("tcp:127.0.0.1:0",), window_lines=100,
                     serve_dir=str(tmp_path / "cpu"), http="off", reload_watch=False)
    drv = PORT.serve.ServeDriver(prefix, PORT.cfg(**SERVE_CFG), scfg,
                                 ascfg=acfg(PORT, max_world=2))
    with pytest.raises(AnalysisError, match="exceeds the 1 available devices"):
        drv.run()


# ---------------------------------------------------------------------------
# Chaos at the decide -> actuate seam (the reference's six seeds).
# ---------------------------------------------------------------------------


def _stopped_or(drv, pred):
    return lambda: drv._stop_req.is_set() or pred()


@pytest.mark.parametrize("seed", range(6))
def test_chaos_autoscale_seam(seed, serve_corpus, tmp_path):
    """The 300-line corpus in 100-line windows; the spool grows by a window
    only once the previous scale decision was issued, so the first and
    second decisions always fall inside the run: a schedule on them aborts
    typed in both packages, the never-firing one publishes three windows
    each equal to the offline replay of its lines."""
    lines = serve_corpus["lines"][:3 * CHAOS_W]
    site, at, _plan = chaos_schedule(seed)
    abort = at <= 2

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        for k in (1, 2):
            wait_for(_stopped_or(drv, lambda k=k: drv.windows_published >= k
                                 and len(drv._engine.decisions) >= k), 60, f"decision {k}")
            write_lines(spool, lines[k * CHAOS_W:(k + 1) * CHAOS_W], mode="a")

    runs = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        write_lines(str(d / "spool.log"), lines[:CHAOS_W])
        a = acfg(side, min_world=2, max_world=8, initial_world=2, reform_budget=4,
                 poll_sec=0.05, plan="out@0.3,in@1.2,out@2.1")
        scfg = scfg_of(side, d, window_lines=CHAOS_W, max_windows=3,
                       checkpoint_every_windows=(1 if seed % 2 else 0),
                       checkpoint_dir=str(d / "ck"))
        err = (AnalysisError if side is PORT else RAnalysisError) if abort else None
        runs[side.name] = serve_run(side, serve_corpus["prefix"],
                                    side.cfg(**SERVE_CFG, fault_plan=f"{site}@{at}"), scfg,
                                    script, expect_error=err, **drv_kw(side, a))
    ref, port = runs["ref"], runs["port"]
    if abort:
        # the typed abort: the injected failure at the seam, never a
        # half-applied scale event
        assert type(port.error).__name__ == type(ref.error).__name__ == "InjectedFault"
        assert str(port.error) == str(ref.error) and site in str(port.error)
        return
    for run in (ref, port):
        assert run.summary["windows_published"] == 3 and run.summary["drops"] == 0
    for i in range(3):
        seg = lines[i * CHAOS_W:(i + 1) * CHAOS_W]
        got = image(port.files[f"window-{i:06d}.json"])
        assert got == image(ref.files[f"window-{i:06d}.json"]), f"seed {seed}: window {i}"
        assert got == offline(REF, serve_corpus, seg), f"seed {seed}: window {i}"
        assert got == offline(PORT, serve_corpus, seg), f"seed {seed}: window {i}"


# ---------------------------------------------------------------------------
# Window fidelity across plan-driven scale events.
# ---------------------------------------------------------------------------


def test_serve_autoscale_plan_windows_bit_identical(serve_corpus, tmp_path):
    """Three 200-line windows; the plan scales 2 -> 4 at 0.3 s and 4 -> 2 at
    1.0 s, and the spool grows to the middle of the next window only once
    each event is applied, so windows 1 and 2 each straddle one."""
    lines = serve_corpus["lines"][:600]
    w = 200

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        for k, world, part in ((1, 4, lines[300:500]), (2, 2, lines[500:])):
            wait_for(lambda k=k, world=world: len(drv._engine.decisions) >= k
                     and drv.world == world, 60, f"scale event {k}")
            write_lines(spool, part, mode="a")
        wait_for(lambda: drv.windows_published >= 3, 60, "three windows")

    runs = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        write_lines(str(d / "spool.log"), lines[:300])
        a = acfg(side, min_world=2, max_world=8, initial_world=2, poll_sec=0.05,
                 plan="out@0.3,in@1.0")
        runs[side.name] = serve_run(side, serve_corpus["prefix"], side.cfg(**SERVE_CFG),
                                    scfg_of(side, d, window_lines=w, max_windows=3), script,
                                    **drv_kw(side, a))
    ref, port = runs["ref"], runs["port"]
    for run in (ref, port):
        s = run.summary
        assert s["windows_published"] == 3 and s["drops"] == 0, s
        asum = s["autoscale"]
        # the reversal 0.7 s after the scale-out falls inside the damping
        # window (2 x (cooldown + sustain) = 6 s): one flap, by the engine's rule
        assert asum["scale_out"] == 1 and asum["scale_in"] == 1 and asum["flaps"] == 1
        assert [(x["from_world"], x["to_world"]) for x in asum["decisions"]] == [(2, 4), (4, 2)]
        assert all(x["reason"] == "plan" for x in asum["decisions"])
        assert all(x["evidence"]["time_to_effect_sec"] >= 0 for x in asum["decisions"])
    assert port.summary["world"] == 2
    for i in range(3):
        seg = lines[i * w:(i + 1) * w]
        got = image(port.files[f"window-{i:06d}.json"])
        assert got == image(ref.files[f"window-{i:06d}.json"]), f"window {i}"
        assert got == offline(REF, serve_corpus, seg), f"window {i} != the reference's replay"
        assert got == offline(PORT, serve_corpus, seg), f"window {i} != the port's replay"
    # the ring checkpoint's fingerprint pins the ladder's maximum, not the world
    assert port.drv._fp_world == ref.drv._fp_world == 8


# ---------------------------------------------------------------------------
# The signal-driven burst out and idle in (the port alone).
# ---------------------------------------------------------------------------


def test_serve_autoscale_burst_out_idle_in(serve_corpus, tmp_path):
    """A 30000-line burst in one spool: the queue's occupancy stays above the
    out threshold for longer than the sustain window, so the mesh scales out
    on backpressure; once the queue drains, starvation scales it back in.
    No drop, no flap, every decision on the ladder, and the windows that
    cover the burst equal the port's fixed-world replay of their lines.
    Bounded by its own limits: the serve stops itself after 60 s."""
    lines = serve_corpus["lines"] * 10
    w = 5000
    d = tmp_path / "burst"
    d.mkdir()
    write_lines(str(d / "spool.log"), lines)
    # one rung up (2 -> 4): the one scale-out lands within the burst's first
    # second, far outside the damping window of the scale-in after the drain
    a = acfg(PORT, min_world=2, max_world=4, initial_world=2, out_threshold=0.05,
             in_threshold=0.8, sustain_sec=0.3, cooldown_sec=0.5, reform_budget=4,
             poll_sec=0.05)

    def script(drv, http):
        wait_for(lambda: any(x.direction == "out" for x in drv._engine.decisions), 45,
                 "scale-out under the burst")
        wait_for(lambda: drv.windows_published >= len(lines) // w, 45, "every window")
        wait_for(lambda: any(x.direction == "in" for x in drv._engine.decisions), 45,
                 "scale-in after the burst")
        return {"gauges": drv.metrics_gauges()}

    run = serve_run(PORT, serve_corpus["prefix"], PORT.cfg(**SERVE_CFG),
                    scfg_of(PORT, d, window_lines=w, ring=8, queue_lines=len(lines) * 2,
                            stop_after_sec=60), script, **drv_kw(PORT, a))
    s = run.summary
    assert s["drops"] == 0 and s["windows_published"] == len(lines) // w
    asum = s["autoscale"]
    assert asum["scale_out"] >= 1 and asum["scale_in"] >= 1 and asum["flaps"] == 0
    outs = [x for x in asum["decisions"] if x["direction"] == "out"]
    ins = [x for x in asum["decisions"] if x["direction"] == "in"]
    assert outs[0]["reason"] == "backpressure"
    assert outs[0]["evidence"]["pressure"]["min"] >= a.out_threshold
    assert ins[0]["reason"] == "starvation"
    ladder = world_ladder(2, 4, divisors_of=4)
    assert all(x["to_world"] in ladder for x in asum["decisions"])
    g = run.http["gauges"]
    assert g["autoscale_scale_out_total"] == asum["scale_out"]
    assert g["world"] == s["world"]
    for i in (0, 1):
        seg = lines[i * w:(i + 1) * w]
        assert image(run.files[f"window-{i:06d}.json"]) == offline(PORT, serve_corpus, seg), \
            f"window {i}"
