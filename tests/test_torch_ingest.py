"""Pipelined ingest: prefetch depths agree, failures surface typed.

Runs on the CPU device, where ``PrefetchingSource`` works without pinned
buffers or streams (the card's path is ``tests/test_torch_cuda.py``).
Registers and reports at prefetch depths 0, 1, 2 and 8 are identical for
text (native and Python parse), plain wire and weighted wire input; a
producer exception reaches the caller typed; a stalled producer raises
``StallError``; the producer thread is joined when the run ends, also
when it ends early; counters count only committed batches.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ruleset_analysis_tpu.runtime.metrics import LatencyHistogram as RLatency
from ruleset_analysis_tpu_torch.config import AnalysisConfig
from ruleset_analysis_tpu_torch.errors import AnalysisError, IngestError, StallError
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire
from ruleset_analysis_tpu_torch.runtime import ingest
from ruleset_analysis_tpu_torch.runtime.metrics import LatencyHistogram
from ruleset_analysis_tpu_torch.runtime.report import VOLATILE_TOTALS
from ruleset_analysis_tpu_torch.runtime.stream import (
    _run_core, run_stream_file, run_stream_wire,
)

B = 500


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=13, egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    lines = synth.render_syslog(packed, synth.synth_flow_tuples(packed, 5000, 300, seed=13),
                                seed=13, variety=0.3)
    d = tmp_path_factory.mktemp("ingest")
    (d / "fw1.log").write_text("\n".join(lines) + "\n")
    logs = [str(d / "fw1.log")]
    wire.convert_logs(packed, logs, str(d / "p.rawire"), block_rows=333)
    wire.convert_logs(packed, logs, str(d / "w.rawire"), block_rows=333, coalesce=True,
                      batch_size=B)
    return packed, logs, d


def _strip(rep) -> dict:
    import json

    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS:
        obj["totals"].pop(k, None)
    return obj


RUNS = {
    "native": lambda p, logs, d, cfg: run_stream_file(p, logs, cfg, native=True,
                                                      return_state=True),
    "python": lambda p, logs, d, cfg: run_stream_file(p, logs, cfg, native=False,
                                                      return_state=True),
    "wire": lambda p, logs, d, cfg: run_stream_wire(p, str(d / "p.rawire"), cfg,
                                                    return_state=True),
    "weighted": lambda p, logs, d, cfg: run_stream_wire(p, str(d / "w.rawire"), cfg,
                                                        return_state=True),
}


@pytest.mark.parametrize("kind", list(RUNS))
def test_prefetch_depths_give_identical_registers_and_reports(corpus, kind):
    packed, logs, d = corpus
    # weighted rows are ~1/4 of the lines: a narrower batch keeps >= 8 chunks
    impl, b = ("scan", 128) if kind == "weighted" else ("fused", B)
    out = {}
    for depth in (0, 1, 2, 8):
        cfg = AnalysisConfig(batch_size=b, device="cpu", prefetch_depth=depth, match_impl=impl)
        out[depth] = RUNS[kind](packed, logs, d, cfg)
    rep0, regs0 = out[0]
    assert "ingest" not in rep0.totals
    for depth in (1, 2, 8):
        rep, regs = out[depth]
        for k, v in regs0.items():
            assert (regs[k] == v).all(), (depth, k)
        assert _strip(rep) == _strip(rep0)
        ing = rep.totals["ingest"]
        assert ing["prefetch_depth"] == depth and ing["batches"] == rep.totals["chunks"]
        assert rep.totals["latency"]["batch_e2e"]["count"] == ing["batches"]
    assert rep0.totals["chunks"] >= 8


def test_coalesced_text_run_under_prefetch(corpus):
    packed, logs, _ = corpus
    reps = [run_stream_file(packed, logs, AnalysisConfig(
        batch_size=B, device="cpu", prefetch_depth=depth, match_impl="scan", coalesce="on"))
        for depth in (0, 2)]
    assert _strip(reps[0]) == _strip(reps[1])
    assert reps[1].totals["coalesce"]["unique_rows"] < reps[1].totals["coalesce"]["raw_rows"]


class _Source:
    """A scripted source: batches from a list, then an exception or a stall."""

    def __init__(self, packed, n_batches, then=None, sleep=0.0):
        self.packer = type("P", (), {"parsed": 0, "skipped": 0})()
        t = synth.synth_tuples(packed, 64 * n_batches, seed=1)
        self._batches = [np.ascontiguousarray(t[i * 64:(i + 1) * 64].T) for i in range(n_batches)]
        self._then = then
        self._sleep = sleep

    def batches(self, skip, b):
        for x in self._batches:
            self.packer.parsed += 64
            yield x, 64
        if self._sleep:
            time.sleep(self._sleep)
        if self._then is not None:
            raise self._then


def _producers() -> list:
    return [t for t in threading.enumerate() if t.name == "ra-ingest-producer"]


@pytest.mark.parametrize("exc, typ", [
    (ValueError("bad row"), IngestError), (AnalysisError("typed already"), AnalysisError),
])
def test_producer_exception_surfaces_typed(corpus, exc, typ):
    packed, _, _ = corpus
    cfg = AnalysisConfig(batch_size=64, device="cpu", prefetch_depth=2)
    with pytest.raises(typ) as info:
        _run_core(packed, _Source(packed, 3, then=exc), cfg, topk=5)
    if typ is IngestError:
        assert info.value.__cause__ is exc and "ValueError: bad row" in str(info.value)
    else:
        assert info.value is exc
    for t in _producers():
        t.join(timeout=10)
    assert not _producers()


def test_stalled_producer_raises_stall_error(corpus):
    packed, _, _ = corpus
    cfg = AnalysisConfig(batch_size=64, device="cpu", prefetch_depth=1, stall_timeout_sec=0.3)
    # without the watchdog the producer would end normally after 2 s
    with pytest.raises(StallError, match="no progress in 0.3s"):
        _run_core(packed, _Source(packed, 2, sleep=2.0), cfg, topk=5)
    assert not _producers()  # closing the run joined the producer


def test_early_stop_joins_the_producer_and_commits_consumed_counts(corpus):
    packed, _, _ = corpus
    src = ingest.PrefetchingSource(_Source(packed, 10), depth=2)
    it = src.batches(0, 64)
    for _ in range(3):
        next(it)
    # the producer ran ahead, but only consumed batches are committed
    assert src.packer.parsed == 3 * 64 and src.stats.batches == 3
    it.close()
    src.close()
    assert not _producers()
    assert src.ingest_stats()["prefetch_depth"] == 2


def test_h2d_ring_needs_a_card_and_host_tensor_copies_read_only_arrays():
    with pytest.raises(ValueError, match="CUDA device"):
        ingest.H2DRing(torch.device("cpu"), 4)
    a = np.arange(8, dtype=np.uint32)
    a.flags.writeable = False
    t = ingest.host_tensor(a)
    t[0] = 7
    assert a[0] == 0 and t.dtype == torch.int32
    b = np.arange(8, dtype=np.uint32)
    assert ingest.host_tensor(b).data_ptr() == b.ctypes.data  # writable: no copy
    db = ingest.to_device(b, torch.device("cpu"))
    assert db.ready is None and db.use() is db.tensor


def test_invalid_depths_and_timeouts_are_refused(corpus):
    packed, _, _ = corpus
    with pytest.raises(ValueError):
        AnalysisConfig(prefetch_depth=-1)
    with pytest.raises(ValueError):
        AnalysisConfig(prefetch_depth=1025)
    with pytest.raises(ValueError):
        AnalysisConfig(stall_timeout_sec=0)
    with pytest.raises(ValueError):
        ingest.PrefetchingSource(_Source(packed, 1), depth=0)


def test_latency_histogram_equals_reference():
    rng = np.random.default_rng(3)
    mine, ref = LatencyHistogram(), RLatency()
    for s in np.concatenate([rng.exponential(0.01, 500), [0.0, 1e-7, 1e-6, 5e4, 1e6]]):
        mine.record(float(s))
        ref.record(float(s))
    assert mine.summary() == ref.summary() and mine.counts == ref.counts
