"""The port's retry engine (runtime/retrypolicy.py, errors.is_transient)
against the reference's.

- **Units**: the policy-spec grammar and its refusals, the site registry,
  the seeded backoff (equal to the reference's, and the same in a fresh
  interpreter), budgets and permanent escalation, and the classification
  table, where the port reads torch's errors in place of XLA's status
  tokens (a CUDA out-of-memory is transient, a CUDA launch or memory
  error is permanent).
- **Transient schedules**: the reference's twelve ``site@N:k`` plans over
  the stream loop.  Both packages recover to the fault-free report, and
  their retry counters are equal.
- **Exhaustion**: ``site@1:99`` plans end in the reference's typed abort,
  with equal counters, and leave no checkpoint litter.
- **The ring feeder's copy**: a retried copy packs from slots that are
  still held, and releases each slot exactly once.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu import errors as rerrors  # noqa: E402
from tests._torch_faultkit import (  # noqa: E402
    BOTH, FAST_RETRY, PORT, REF, make_corpus, reset_all,
)
from ruleset_analysis_tpu_torch import errors  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import compact_batch  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import faults, ingest, retrypolicy  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("retry"), 1500, seed=21)


@pytest.fixture(scope="module")
def baselines(corpus, tmp_path_factory):
    """The port's fault-free images keyed (input, depth, cadence)."""
    cache: dict = {}
    td = tmp_path_factory.mktemp("retry_base")

    def get(inp, depth, cadence):
        key = (inp, depth, cadence)
        if key not in cache:
            cfg = PORT.cfg(prefetch_depth=depth, checkpoint_every_chunks=cadence,
                           checkpoint_dir=str(td / f"ck-{inp}-{depth}-{cadence}"))
            cache[key] = PORT.outcome(corpus, inp, cfg)[0]
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


def test_site_registry_and_default_policies_equal_the_references():
    assert list(retrypolicy.RETRY_SITES) == list(REF.retry.RETRY_SITES)
    for site, meta in retrypolicy.RETRY_SITES.items():
        assert meta.fault_site == REF.retry.RETRY_SITES[site].fault_site
        assert meta.fault_site in faults.SITES, site
    assert {s: vars(p) for s, p in retrypolicy.DEFAULT_POLICIES.items()} == {
        s: vars(p) for s, p in REF.retry.DEFAULT_POLICIES.items()}
    assert retrypolicy.ENV_VAR == REF.retry.ENV_VAR


@pytest.mark.parametrize("spec", [
    "device_put=7/0.5,seed=9", "checkpoint.save=3", "off", " off ", "wire.read=2,seed=4",
    "listener.bind=6/0.2,serve.publish=1", "dist.epoch.ship=4/0.05", "seed=11", "",
])
def test_policy_specs_parse_as_in_the_reference(spec):
    got, want = (side.retry.parse_spec(spec) for side in BOTH)
    assert got[1] == want[1]
    assert {s: vars(p) for s, p in got[0].items()} == {s: vars(p) for s, p in want[0].items()}


@pytest.mark.parametrize("spec", [
    "nosuch=3", "device_put", "device_put=x", "seed=x", "device_put=0", "device_put=2/x",
    "device_put=2/-1",
])
def test_bad_policy_specs_are_refused_alike(spec):
    msgs = []
    for side in BOTH:
        with pytest.raises(side.errors.AnalysisError) as ei:
            side.retry.configure(spec)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("site", sorted(retrypolicy.RETRY_SITES))
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_backoff_schedule_equals_the_references(site, seed):
    for side in BOTH:
        side.retry.configure("")
    got, want = (side.retry.backoff_schedule(site, 8, seed=seed) for side in BOTH)
    assert got == want
    pol = retrypolicy.DEFAULT_POLICIES[site]
    for i, d in enumerate(got):
        raw = min(pol.cap_sec, pol.base_sec * pol.mult ** i)
        assert 0.5 * raw <= d < 1.5 * raw


def test_backoff_is_the_same_in_a_fresh_interpreter():
    """Jitter is crc32 of (seed, site, attempt), never hash(): a fresh
    interpreter with a random hash seed gives the same delays."""
    env = dict(os.environ, PYTHONHASHSEED="random")
    out = subprocess.run(
        [sys.executable, "-c",
         "import json\n"
         "from ruleset_analysis_tpu_torch.runtime import retrypolicy\n"
         "print(json.dumps(retrypolicy.backoff_schedule('checkpoint.save', 6, seed=42)))"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip()) == REF.retry.backoff_schedule(
        "checkpoint.save", 6, seed=42)


def _always(side, exc_of):
    n = {"calls": 0}

    def fn():
        n["calls"] += 1
        raise exc_of(side)

    return fn, n


def test_budget_exhaustion_and_permanent_escalation_count_alike():
    seen = []
    for side in BOTH:
        side.retry.configure("device_put=3/0.001")
        fn, n = _always(side, lambda s: s.errors.CheckpointCorrupt("no"))
        with pytest.raises(side.errors.CheckpointCorrupt):
            side.retry.call("device_put", fn)
        first = (n["calls"], side.retry.counters())
        fn, n = _always(side, lambda s: s.errors.InjectedFault("t"))
        with pytest.raises(side.errors.InjectedFault):
            side.retry.call("device_put", fn)
        seen.append((first, n["calls"], side.retry.counters(), side.retry.gauges()))
    assert seen[0] == seen[1]
    (first_calls, first_ctr), calls, ctr, gauges = seen[0]
    assert first_calls == 1 and first_ctr["device_put"] == {
        "attempts": 0, "recoveries": 0, "giveups": 1}
    assert calls == 3 and ctr["device_put"]["attempts"] == 2
    assert gauges["retry_device_put_giveups"] == 2 and gauges["retry_attempts_total"] == 2


def test_recovery_and_the_per_run_budget_count_alike():
    seen = []
    for side in BOTH:
        side.retry.configure("wire.read=4/0.001")
        left = {"n": 2}

        def flaky(side=side, left=left):
            if left["n"]:
                left["n"] -= 1
                raise side.errors.InjectedFault("t")
            return "ok"

        assert side.retry.call("wire.read", flaky) == "ok"
        seen.append(side.retry.counters())
    assert seen[0] == seen[1] == {"wire.read": {"attempts": 2, "recoveries": 1, "giveups": 0}}


def test_off_spec_disables_retries():
    for side in BOTH:
        side.retry.configure("off")
        fn, n = _always(side, lambda s: s.errors.InjectedFault("t"))
        with pytest.raises(side.errors.InjectedFault):
            side.retry.call("wire.read", fn)
        assert n["calls"] == 1


def _errno(name):
    import errno

    return getattr(errno, name)


#: exceptions both tables classify (no RuntimeError: there the reference
#: reads XLA status tokens and the port torch's errors)
CASES = {
    "injected": lambda e: e.InjectedFault("x"),
    "typed refusal": lambda e: e.CheckpointCorrupt("x"),
    "analysis error": lambda e: e.AnalysisError("x"),
    "stall": lambda e: e.StallError("x"),
    "connection reset": lambda e: ConnectionResetError("x"),
    "timeout": lambda e: TimeoutError("x"),
    "interrupted": lambda e: InterruptedError("x"),
    "blocking": lambda e: BlockingIOError("x"),
    "EADDRINUSE": lambda e: OSError(_errno("EADDRINUSE"), "in use"),
    "EIO": lambda e: OSError(_errno("EIO"), "io"),
    "ENOSPC": lambda e: OSError(_errno("ENOSPC"), "full"),
    "EBADF": lambda e: OSError(_errno("EBADF"), "bad fd"),
    "missing file": lambda e: FileNotFoundError("x"),
    "permission": lambda e: PermissionError("x"),
    "is a directory": lambda e: IsADirectoryError("x"),
    "value": lambda e: ValueError("x"),
    "key": lambda e: KeyError("x"),
    "memory": lambda e: MemoryError("x"),
}


@pytest.mark.parametrize("case", CASES)
def test_classification_table_is_the_references(case):
    mk = CASES[case]
    assert errors.is_transient(mk(errors)) == rerrors.is_transient(mk(rerrors))
    assert errors.TRANSIENT_ERRNOS == rerrors.TRANSIENT_ERRNOS


@pytest.mark.parametrize("exc,transient", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: misaligned address"), False),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), False),
    (RuntimeError("shape mismatch"), False),
    (errors.KernelError("first_match: launch failed (an illegal memory access)"), False),
])
def test_torch_errors_classify_by_what_they_do_to_the_context(exc, transient):
    """An allocation that ran out of device memory may clear (the counterpart
    of RESOURCE_EXHAUSTED); a CUDA error poisons the context and never does."""
    assert errors.is_transient(exc) is transient


def test_a_cuda_error_at_the_copy_seam_escalates_at_once(corpus, monkeypatch):
    """A poisoned context is never retried: the error leaves the first
    attempt unchanged, with one giveup and no retry."""
    calls = {"n": 0}

    def broken(arr, device, ring=None):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(mesh_lib, "to_device", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        PORT.run(corpus, "text", PORT.cfg(prefetch_depth=0))
    assert calls["n"] == 1
    assert retrypolicy.counters()["device_put"] == {"attempts": 0, "recoveries": 0,
                                                    "giveups": 1}


def test_a_cuda_oom_at_the_copy_seam_is_retried(corpus, baselines, monkeypatch):
    real = mesh_lib.to_device
    left = {"n": 2}

    def short_of_memory(arr, device, ring=None):
        if left["n"]:
            left["n"] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 GiB")
        return real(arr, device, ring)

    base = baselines("text", 0, 0)
    monkeypatch.setattr(mesh_lib, "to_device", short_of_memory)
    assert PORT.outcome(corpus, "text", PORT.cfg(prefetch_depth=0)) == (base, None)
    assert retrypolicy.counters()["device_put"] == {"attempts": 2, "recoveries": 1,
                                                    "giveups": 0}


# ---------------------------------------------------------------------------
# Transient schedules: both recover to the fault-free report
# ---------------------------------------------------------------------------

TRANSIENT_SCHEDULES = [
    # (plan, input, prefetch depth, checkpoint cadence): the reference's
    ("stream.device_put.fail@1:2,seed=301", "text", 0, 0),
    ("stream.device_put.fail@2:3,seed=302", "text", 2, 0),
    ("stream.device_put.fail@1:4,seed=303", "wire", 0, 0),
    ("stream.device_put.fail@3:2,seed=304", "wire", 2, 0),
    ("stream.device_put.fail@2:2,seed=305", "text", 0, 2),
    ("checkpoint.torn_state@1:2,seed=306", "text", 0, 2),
    ("checkpoint.torn_state@2:3,seed=307", "wire", 0, 2),
    ("checkpoint.torn_state@1:1,seed=308", "wire", 2, 2),
    ("checkpoint.torn_manifest@1:2,seed=309", "text", 0, 2),
    ("checkpoint.torn_manifest@2:2,seed=310", "wire", 2, 2),
    ("stream.wire.read.fail@1:2,seed=311", "wire", 0, 0),
    ("stream.wire.read.fail@1:3,seed=312", "wire", 2, 2),
]


def _retry_site(plan: str) -> str:
    site = plan.split("@")[0]
    if site == "checkpoint.torn_manifest":
        return "checkpoint.save"
    return next(s for s, m in retrypolicy.RETRY_SITES.items() if m.fault_site == site)


@pytest.mark.parametrize("plan,inp,depth,cadence", TRANSIENT_SCHEDULES)
def test_transient_schedule_recovers_as_in_the_reference(corpus, baselines, tmp_path, plan,
                                                         inp, depth, cadence):
    got = {}
    for side in BOTH:
        cfg = side.cfg(prefetch_depth=depth, checkpoint_every_chunks=cadence,
                       checkpoint_dir=str(tmp_path / f"ck-{side.name}"))
        img, err = side.outcome(corpus, inp, cfg, plan)
        got[side.name] = (img, err, side.retry.counters())
        reset_all()
    assert got["port"][1] is None and got["ref"][1] is None, got
    assert got["port"][0] == got["ref"][0] == baselines(inp, depth, cadence)
    assert got["port"][2] == got["ref"][2]
    c = got["port"][2][_retry_site(plan)]
    assert c["recoveries"] >= 1 and c["giveups"] == 0, c


# ---------------------------------------------------------------------------
# Exhaustion: the reference's typed aborts, with equal counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan,inp,cadence", [
    ("stream.device_put.fail@1:99", "text", 0),
    ("stream.device_put.fail@2:99", "wire", 0),
    ("checkpoint.torn_manifest@1:99", "text", 2),
    ("checkpoint.torn_state@2:99", "wire", 2),
    ("stream.wire.read.fail@1:99", "wire", 0),
])
def test_exhausted_schedule_ends_in_the_references_abort(corpus, baselines, tmp_path, plan,
                                                         inp, cadence):
    got = {}
    for side in BOTH:
        ck = tmp_path / f"ck-{side.name}"
        cfg = side.cfg(prefetch_depth=0, checkpoint_every_chunks=cadence,
                       checkpoint_dir=str(ck))
        img, err = side.outcome(corpus, inp, cfg, plan)
        got[side.name] = (img, err, side.retry.counters())
        # the retried attempts leave no tmp litter
        assert not [e for e in (os.listdir(ck) if ck.exists() else [])
                    if e.startswith(".tmp-")]
        reset_all()
    assert got["port"] == got["ref"]
    assert got["port"][1] == ("InjectedFault", 1)
    assert got["port"][2][_retry_site(plan)]["giveups"] >= 1
    # the process is healthy afterwards: a disarmed run is the baseline
    cfg = PORT.cfg(prefetch_depth=0, checkpoint_dir=str(tmp_path / "ck-after"))
    assert PORT.outcome(corpus, "text", cfg)[0] == baselines("text", 0, 0)


def test_cli_validates_retry_policy_and_fault_plan_eagerly(corpus, tmp_path, capsys,
                                                           monkeypatch):
    """A malformed --retry-policy or --fault-plan is the usage error (2)
    in both CLIs, before any run."""
    from tests._torch_faultkit import ref_one_device

    ref_one_device(monkeypatch)
    for flags in (["--retry-policy", "nosuch=3"], ["--retry-policy", "device_put=x"],
                  ["--fault-plan", "no.such.site@1"], ["--fault-plan", "ingest.producer.raise@0"],
                  ["--fault-plan", "@" + str(tmp_path / "missing.plan")],
                  ["--blackbox", "off", "--blackbox-dir", str(tmp_path / "bb")]):
        rcs = []
        for side in BOTH:
            extra = ["--device", "cpu"] if side is PORT else []
            rcs.append(side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs",
                                      corpus["text"], "--json", "--out",
                                      str(tmp_path / "r.json"), *extra, *flags]))
        assert rcs == [2, 2], flags
        assert not (tmp_path / "r.json").exists()


# ---------------------------------------------------------------------------
# The ring feeder's copy: retried inside, slots released exactly once
# ---------------------------------------------------------------------------


class _Batch:
    """A ring feeder batch stand-in that counts its releases."""

    def __init__(self, views):
        self.views = views
        self.releases = 0

    def release(self):
        self.releases += 1
        self.views = []  # as _RingBatch: no view outlives its slot


def _views(n_views: int, width: int):
    rng = np.random.default_rng(5)
    from ruleset_analysis_tpu_torch.hostside.pack import TUPLE_COLS

    out = []
    for _ in range(n_views):
        v = rng.integers(0, 1 << 16, size=(TUPLE_COLS, width), dtype=np.uint32)
        v[6] = 1  # valid
        out.append(v)
    return out


@pytest.mark.parametrize("plan,recovers", [
    ("stream.device_put.fail@1:2", True), ("stream.device_put.fail@1:99", False),
])
def test_a_retried_ring_copy_releases_each_slot_once(plan, recovers):
    cpu = torch.device("cpu")
    views = _views(1, 64)
    want = compact_batch(views[0])
    retrypolicy.configure(FAST_RETRY)
    rb = _Batch(list(views))
    with faults.armed(faults.FaultPlan.parse(plan)):
        if recovers:
            got = ingest.views_to_device(rb, cpu)
        else:
            with pytest.raises(errors.InjectedFault):
                ingest.views_to_device(rb, cpu)
    assert rb.releases == 1
    ctr = retrypolicy.counters()["device_put"]
    if recovers:
        # the second attempt packed the still-held slots: the right bits
        np.testing.assert_array_equal(got.tensor.numpy().view(np.uint32), want)
        assert ctr == {"attempts": 2, "recoveries": 1, "giveups": 0}
    else:
        assert ctr["giveups"] == 1 and ctr["recoveries"] == 0


@pytest.mark.parametrize("plan,recovers", [
    ("stream.device_put.fail@1:3", True), ("stream.device_put.fail@1:99", False),
])
def test_a_retried_sharded_ring_copy_releases_each_slot_once(plan, recovers):
    cpu = torch.device("cpu")
    mesh = mesh_lib.make_mesh([cpu, cpu])
    views = _views(2, 32)
    retrypolicy.configure(FAST_RETRY)
    rb = _Batch(list(views))
    with faults.armed(faults.FaultPlan.parse(plan)):
        if recovers:
            got = mesh_lib.shard_ring_batch(mesh, rb)
        else:
            with pytest.raises(errors.InjectedFault):
                mesh_lib.shard_ring_batch(mesh, rb)
    assert rb.releases == 1
    if recovers:
        for g, v in zip(got, views):
            np.testing.assert_array_equal(g.tensor.numpy().view(np.uint32), compact_batch(v))


@pytest.mark.parametrize("plan", ["stream.device_put.fail@2:3", "stream.device_put.fail@2:99"])
def test_ring_feeder_schedule_equals_the_reference(corpus, tmp_path, plan):
    """The whole ring feeder path under a device_put schedule: recovered to
    the reference's report, or its typed abort, with equal counters and no
    leaked worker or segment."""
    ensure_reference_native()
    got = {}
    for side in BOTH:
        cfg = side.cfg(prefetch_depth=2, batch_size=256,
                       checkpoint_dir=str(tmp_path / f"ck-{side.name}"))
        got[side.name] = (*side.outcome(corpus, "text", cfg, plan, feed_workers=2,
                                        feed_mode="ring"),
                          side.retry.counters())
        reset_all()
    assert got["port"] == got["ref"]
    assert (got["port"][1] is None) == plan.endswith(":3")
