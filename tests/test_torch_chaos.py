"""Seeded fault schedules over the port's run path, against the reference.

The reference's chaos invariant: under any armed schedule a run either
gives the fault-free report or ends in a typed ``AnalysisError``, never a
hang, a silent wrong answer or a leaked worker.  Here each schedule runs
through both packages, which must agree on the outcome: the same report
(apart from volatile totals and the backend), or the same error class and
exit code.  A schedule that tore a checkpoint resumes, in both, to the
fault-free report.  The feed tiers' sites (a wedged or killed process,
thread or ring worker) end in the reference's failure class, and a
damaged wire block in its ``WireCorrupt``.
"""

import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tests._torch_faultkit import BOTH, PORT, STALL_SEC, make_corpus, reset_all  # noqa: E402
from ruleset_analysis_tpu_torch import errors  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import fastparse  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("chaos"), 2500, seed=11)


@pytest.fixture(scope="module")
def baselines(corpus, tmp_path_factory):
    """The port's fault-free images keyed (layout, input, cadence)."""
    cache: dict = {}
    td = tmp_path_factory.mktemp("chaos_base")

    def get(layout, inp, cadence):
        key = (layout, inp, cadence)
        if key not in cache:
            cfg = PORT.cfg(prefetch_depth=0, layout=layout, checkpoint_every_chunks=cadence,
                           checkpoint_dir=str(td / f"ck-{layout}-{inp}-{cadence}"))
            cache[key] = PORT.outcome(corpus, inp, cfg)[0]
        return cache[key]

    return get


def schedule_for(seed: int):
    """The reference's seeded schedule: a combination and one armed site."""
    rng = random.Random(seed)
    layout = rng.choice(["flat", "stacked"])
    inp = rng.choice(["text", "wire"])
    depth = rng.choice([0, 2])
    coalesce = rng.choice(["off", "on"]) if layout == "flat" else "off"
    sites = ["stream.device_put.fail", "checkpoint.torn_state", "checkpoint.torn_manifest"]
    if depth:
        sites += ["ingest.producer.raise", "ingest.queue.stall"]
    if inp == "wire":
        sites += ["stream.wire.corrupt"]
    if coalesce != "off":
        sites += ["ingest.coalesce.fail"]
    site = rng.choice(sites)
    cadence = 2 if site.startswith("checkpoint.") else rng.choice([0, 2])
    plan = f"{site}@{rng.randint(1, 4)},seed={seed}"
    return layout, inp, depth, cadence, coalesce, plan


def test_schedules_are_the_references():
    """The copy of the seeded schedule draws the reference suite's."""
    from tests.test_chaos import schedule_for as ref_schedule_for

    for seed in range(40):
        *combo, plan = schedule_for(seed)
        *rcombo, rplan = ref_schedule_for(seed)
        assert combo == rcombo, seed
        assert PORT.faults.FaultPlan.parse(plan).to_str() == rplan.to_str(), seed


@pytest.mark.parametrize("seed", range(20))
def test_chaos_schedule_ends_as_in_the_reference(seed, corpus, baselines, tmp_path):
    layout, inp, depth, cadence, coalesce, plan = schedule_for(seed)
    base = baselines(layout, inp, cadence)
    got = {}
    stall = {"stall_timeout_sec": STALL_SEC} if "stall" in plan else {}
    for side in BOTH:
        ck = str(tmp_path / f"ck-{side.name}")
        cfg = side.cfg(prefetch_depth=depth, layout=layout, checkpoint_every_chunks=cadence,
                       checkpoint_dir=ck, coalesce=coalesce, **stall)
        img, err = side.outcome(corpus, inp, cfg, plan)
        reset_all()
        if err is not None and cadence:
            # whatever the fault tore mid-save, the pointer and the CRCs
            # serve a consistent snapshot, and the resume is exact
            cfg = side.cfg(prefetch_depth=depth, layout=layout,
                           checkpoint_every_chunks=cadence, checkpoint_dir=ck,
                           coalesce=coalesce, resume=True)
            assert side.outcome(corpus, inp, cfg)[0] == base, f"seed {seed}: {side.name}"
            assert not [e for e in os.listdir(ck)
                        if e.startswith(".tmp-") or e.endswith(".ptr.tmp")]
            reset_all()
        got[side.name] = (img, err)
    assert got["port"] == got["ref"], f"seed {seed} ({plan}): {got['port'][1]} {got['ref'][1]}"
    if got["port"][1] is None:
        assert got["port"][0] == base, f"seed {seed} silently diverged"


# ---------------------------------------------------------------------------
# The feed tiers' sites
# ---------------------------------------------------------------------------

FEED_CASES = {
    # name: (plan, feed mode, prefetch depth, the failure classes allowed)
    "thread stall": ("feeder.worker.stall@2", "thread", 0, {"StallError"}),
    "process crash": ("feeder.worker.crash@2", "process", 0,
                      {"FeedWorkerError", "StallError"}),
    "thread stall under prefetch": ("feeder.worker.stall@3", "thread", 2,
                                    {"StallError", "FeedWorkerError", "IngestError"}),
    "ring stall": ("feeder.ring.stall@2", "ring", 0, {"StallError"}),
    "ring stall under prefetch": ("feeder.ring.stall@3", "ring", 2,
                                  {"StallError", "FeedWorkerError", "IngestError"}),
    "ring worker crash": ("feeder.worker.crash@2", "ring", 0,
                          {"FeedWorkerError", "StallError"}),
}


@pytest.mark.parametrize("name", FEED_CASES)
def test_feed_tier_fault_ends_in_the_references_class(name, corpus, tmp_path):
    """A wedged or killed feed worker ends typed, never in a hang, with the
    failure class and exit code the reference gives; the plan reaches the
    spawned workers through the exported RA_FAULT_PLAN."""
    if not fastparse.available():
        pytest.fail("the port's native parser does not build here")
    ensure_reference_native()
    plan, mode, depth, allowed = FEED_CASES[name]
    got = {}
    for side in BOTH:
        cfg = side.cfg(prefetch_depth=depth, checkpoint_dir=str(tmp_path / f"ck-{side.name}"),
                       stall_timeout_sec=STALL_SEC)
        img, err = side.outcome(corpus, "text", cfg, plan, feed_workers=2, feed_mode=mode)
        reset_all()
        assert img is None and err[0] in allowed, (side.name, err)
        got[side.name] = err
    # a stall and a crash race the same watchdog: compare the exit codes'
    # classes where the allowed set holds one class
    if len(allowed) == 1:
        assert got["port"] == got["ref"]
    assert {got["port"][1], got["ref"][1]} <= {errors.EXIT_FEED, errors.EXIT_STALL,
                                              errors.EXIT_ANALYSIS}


def test_exit_codes_map_failure_classes_as_in_the_reference():
    from ruleset_analysis_tpu import errors as rerrors

    for name in ("CheckpointCorrupt", "CheckpointMismatch", "ResumeInputMismatch",
                 "FeedWorkerError", "IngestError", "WireCorrupt", "StallError",
                 "AnalysisError", "InjectedFault", "NativeParserUnavailable"):
        assert errors.exit_code_for(getattr(errors, name)("x")) == rerrors.exit_code_for(
            getattr(rerrors, name)("x")), name
    assert errors.EXIT_CODE_NAMES == rerrors.EXIT_CODE_NAMES


def test_on_disk_wire_valid_bit_damage_is_refused_as_in_the_reference(corpus, tmp_path):
    """One stored row's valid bit cleared in the file: WireCorrupt (exit 5)
    from both."""
    from ruleset_analysis_tpu_torch.hostside.pack import W_META
    from ruleset_analysis_tpu_torch.hostside.wire import HEADER6_BYTES

    wp = tmp_path / "w.rawire"
    wp.write_bytes(open(corpus["wire"], "rb").read())
    r0 = 512  # rows in block 0 ([WIRE_COLS, r0] plane)
    off = HEADER6_BYTES + 4 * (W_META * r0 + 5)
    with open(wp, "r+b") as f:
        f.seek(off)
        word = int.from_bytes(f.read(4), "little")
        assert word & (1 << 23), "picked a non-stored row"
        f.seek(off)
        f.write((word & ~(1 << 23)).to_bytes(4, "little"))
    c = dict(corpus, wire=str(wp))
    got = [side.outcome(c, "wire", side.cfg(prefetch_depth=0)) for side in BOTH]
    assert got[0] == got[1] == (None, ("WireCorrupt", errors.EXIT_FEED))


@pytest.mark.parametrize("plan", ["stream.wire.corrupt@1,seed=3", "stream.wire.corrupt@2,seed=9"])
def test_corrupted_wire_block_is_refused_as_in_the_reference(corpus, plan):
    got = [side.outcome(corpus, "wire", side.cfg(prefetch_depth=0), plan) for side in BOTH]
    assert got[0] == got[1] == (None, ("WireCorrupt", errors.EXIT_FEED))


def test_disarmed_sites_cost_nothing_and_change_nothing():
    """With no plan armed, fire() is a no-op returning its payload, in both."""
    arr = np.arange(4, dtype=np.uint32)
    for side in BOTH:
        assert side.faults.active_plan() is None
        assert side.faults.fire("stream.wire.corrupt", payload=arr) is arr
        assert side.faults.fire("ingest.producer.raise") is None
        assert side.faults.fire("stream.device_put.fail") is None
