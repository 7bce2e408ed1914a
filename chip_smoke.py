#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ruleset_analysis_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds both CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each against its plain torch version on the card
(bit-identical: integer outputs, tolerance 0) at the main path's shapes
and at edge shapes, drives the port's main path (`synth` -> `parse-acls`
-> `run`) through the CLI with the kernels' launch counters zeroed just
before and read just after, checks exact counts against the port's
oracle, times the device step alone, and prints one JSON line per the
format below.  Every failure raises, so the exit code is nonzero; with
no CUDA device, or without the package beside it, it exits nonzero
before printing any result.

Last lines of its standard output:
    {"kernels": [{"name": ..., "route": "cuda", ...}, ...]}
    <nvidia-smi name, power.limit>
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Work files go to build/smoke/ in the checkout (git-ignored).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks for the bound: HBM3 bytes/s (NVIDIA data sheet), and
#: INT32 operations/s outside the tensor cores = 132 SMs x 64 INT32
#: lanes x 1.98 GHz boost clock (Hopper white paper: 64 INT32 units per
#: SM; the same clock gives the data sheet's 67 TFLOP/s FP32 with 128
#: FP32 lanes and 2 FLOPs per FMA).
HBM_BYTES_PER_SEC = 3.35e12
INT32_OPS_PER_SEC = 132 * 64 * 1.98e9
#: integer operations per (line, rule) test of the scan: 1 acl compare,
#: 5 ranges x (1 subtract + 1 compare), 1 select of the first hit
OPS_PER_TEST = 12

FULL_B = 1 << 20
#: (n_acls, rules_per_acl) of the two realistic rulesets: the repo's
#: one-ruleset bench geometry (Rp = 512) and a large edge ruleset (Rp = 7680)
SHAPES = ((4, 64), (16, 256))


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn() on the card: CUDA events around `iters` launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


class Check(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Check(what)


def max_abs_err(got, want) -> int:
    import torch

    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )


def ruleset(n_acls: int, rules_per_acl: int):
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth

    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=0)
    return text, pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])


def line_fields(tuples, dev):
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(tuples[:, i]).view(np.int32)).to(dev)
            for i in range(7)]


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; times and bounds at B = 2^20."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside import synth
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops import first_match, match_hist
    from ruleset_analysis_tpu_torch.ops.hashing import u32_of
    from ruleset_analysis_tpu_torch.ops.match import NO_MATCH

    rows = {}
    err = {"first_match": 0, "match_hist": 0}
    for n_acls, per in SHAPES:
        _, packed = ruleset(n_acls, per)
        r = pipeline.ship_ruleset(packed, dev)
        rp = r.rules_fm.shape[1]
        tuples = synth.synth_tuples(packed, FULL_B, seed=1)
        f = line_fields(tuples, dev)
        fields, valid = f[:6], f[6]

        got = first_match.first_match_rows(fields, r.rules_fm)
        torch.cuda.synchronize()
        want = first_match.first_match_rows_plain(fields, r.rules_fm)
        e = max_abs_err([got], [want])
        check(e == 0, f"first_match != plain at B={FULL_B} Rp={rp} (max abs err {e})")
        err["first_match"] = max(err["first_match"], e)
        for glob in (False, True):
            got2 = match_hist.match_rows_and_hists(fields, valid, r.rules_fm, packed.n_acls,
                                                   force_global=glob)
            torch.cuda.synchronize()
            want2 = match_hist.match_rows_and_hists_plain(fields, valid, r.rules_fm, packed.n_acls)
            e2 = max_abs_err(got2, want2)
            check(e2 == 0, f"match_hist (global_mode={glob}) != plain at B={FULL_B} Rp={rp}")
            err["match_hist"] = max(err["match_hist"], e2)
        say(f"kernels: B={FULL_B} Rp={rp} n_acls={packed.n_acls}: first_match and "
            "match_hist (shared and global-atomic modes) bit-identical to plain "
            "(tolerance 0)")

        # the bound: bytes each input read once and each output written
        # once, and the rule tests this data needs.  A line needs only
        # its own ACL's rows (they are contiguous in config order), up to
        # its first hit, or all of them when none matches; the kernel
        # itself also walks every earlier ACL's rows (`scanned`).
        r64, a64 = u32_of(want), u32_of(fields[0])
        acl_col = torch.from_numpy(packed.rules[:, 0].astype(np.int64)).to(dev)
        own = acl_col < packed.n_acls
        n_rows = torch.bincount(acl_col[own], minlength=packed.n_acls)
        first = torch.full((packed.n_acls,), packed.rules.shape[0], dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, acl_col[own], torch.nonzero(own).flatten(), "amin")
        known = a64 < packed.n_acls
        a_c = torch.clamp(a64, max=packed.n_acls - 1)
        matched = r64 != NO_MATCH
        tests = int(torch.where(matched, r64 - first[a_c] + 1,
                                torch.where(known, n_rows[a_c], 0)).sum())
        scanned = int(torch.where(matched, r64 + 1, packed.rules.shape[0]).sum())
        ops = OPS_PER_TEST * tests
        b1 = 24 * FULL_B + 4 * 12 * rp + 4 * FULL_B
        b2 = 28 * FULL_B + 4 * 12 * rp + 4 * FULL_B + 4 * (rp + match_hist.acl_pad(packed.n_acls))
        ops2 = ops + int(valid.to(torch.int64).sum())
        ms1 = cuda_ms(lambda: first_match.first_match_rows(fields, r.rules_fm), 20)
        ms2 = cuda_ms(lambda: match_hist.match_rows_and_hists(fields, valid, r.rules_fm, packed.n_acls), 20)
        ms2g = cuda_ms(lambda: match_hist.match_rows_and_hists(
            fields, valid, r.rules_fm, packed.n_acls, force_global=True), 20)
        p1 = cuda_ms(lambda: first_match.first_match_rows_plain(fields, r.rules_fm), 2, warmup=1)
        p2 = cuda_ms(lambda: match_hist.match_rows_and_hists_plain(
            fields, valid, r.rules_fm, packed.n_acls), 2, warmup=1)
        for name, ms, plain, nbytes, nops in (
            ("first_match", ms1, p1, b1, ops), ("match_hist", ms2, p2, b2, ops2),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_SEC * 1e3
            t_ops = nops / INT32_OPS_PER_SEC * 1e3
            rows[(name, rp)] = {
                "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            say(f"kernel {name}: B={FULL_B} Rp={rp}: {ms:.4f} ms/launch (plain torch "
                f"{plain:.2f} ms), bound {max(t_bytes, t_ops):.4f} ms by "
                f"{rows[(name, rp)]['bound_by']} ({tests / FULL_B:.1f} rule tests/line needed, "
                f"{scanned / FULL_B:.1f} rows/line walked by the scan)")
        say(f"kernel match_hist global-atomic mode: B={FULL_B} Rp={rp}: {ms2g:.4f} ms/launch")

    # edge shapes: a batch that is not a multiple of the block, all-invalid
    # lines, acl ids >= n_acls (clamped onto the last ACL's deny key)
    _, packed = ruleset(*SHAPES[0])
    r = pipeline.ship_ruleset(packed, dev)
    tuples = synth.synth_tuples(packed, 100003, seed=2)
    tuples[::13, 0] = np.uint32(packed.n_acls + 3)
    tuples[::29, 0] = np.uint32(0xFFFFFFF0)
    tuples[::7, 6] = 0
    f = line_fields(tuples, dev)
    cases = {
        "ragged B=100003 with corrupt acls": (f[:6], f[6]),
        "all-invalid lines": (f[:6], torch.zeros_like(f[6])),
        "one line": ([x[:1].clone() for x in f[:6]], f[6][:1].clone()),
    }
    for what, (fields, valid) in cases.items():
        e = max_abs_err([first_match.first_match_rows(fields, r.rules_fm)],
                        [first_match.first_match_rows_plain(fields, r.rules_fm)])
        check(e == 0, f"first_match != plain on {what}")
        for glob in (False, True):
            got = match_hist.match_rows_and_hists(fields, valid, r.rules_fm, packed.n_acls,
                                                  force_global=glob)
            want = match_hist.match_rows_and_hists_plain(fields, valid, r.rules_fm, packed.n_acls)
            e2 = max_abs_err(got, want)
            check(e2 == 0, f"match_hist (global_mode={glob}) != plain on {what}")
        torch.cuda.synchronize()
        say(f"kernels: edge shape {what}: bit-identical to plain")
    return {"rows": rows, "err": err}


def cli_run(prefix: str, logs: str, impl: str, batch: int) -> tuple[dict, dict]:
    """One `run` through the CLI with the launch counters zeroed around it."""
    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.ops import first_match, match_hist

    out = os.path.join(os.path.dirname(logs), f"report-{impl}-{batch}.json")
    first_match.first_match_rows.launches = 0
    match_hist.match_rows_and_hists.launches = 0
    rc = cli.main(["run", "--ruleset", prefix, "--logs", logs, "--match-impl", impl,
                   "--batch-size", str(batch), "--json", "--out", out])
    launches = {"first_match": first_match.first_match_rows.launches,
                "match_hist": match_hist.match_rows_and_hists.launches}
    check(rc == 0, f"cli run --match-impl {impl} exited {rc}")
    with open(out, encoding="utf-8") as fh:
        rep = json.load(fh)
    check(rep["totals"]["backend"] == "torch-cuda", "the run did not use the CUDA device")
    want = "match_hist" if impl == "fused" else "first_match"
    other = "first_match" if impl == "fused" else "match_hist"
    check(launches[want] == rep["totals"]["chunks"] and launches[want] > 0,
          f"--match-impl {impl}: {want} launched {launches[want]} times over "
          f"{rep['totals']['chunks']} chunks")
    check(launches[other] == 0, f"--match-impl {impl} launched {other}")
    return rep, launches


def strip(rep: dict) -> dict:
    from ruleset_analysis_tpu_torch.runtime.report import VOLATILE_TOTALS

    rep = json.loads(json.dumps(rep))
    for k in VOLATILE_TOTALS:
        rep["totals"].pop(k, None)
    return rep


def phase_main_path(work: str) -> dict:
    """synth -> parse-acls -> run, both match impls, exact vs the oracle."""
    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.hostside import aclparse, oracle

    d = os.path.join(work, "exact")
    check(cli.main(["synth", "--out-dir", d, "--acls", "4", "--rules", "64",
                    "--lines", str(1 << 16), "--seed", "0"]) == 0, "cli synth failed")
    prefix = os.path.join(d, "parsed")
    check(cli.main(["parse-acls", os.path.join(d, "fw1.cfg"), "--out", prefix]) == 0,
          "cli parse-acls failed")
    logs = os.path.join(d, "fw1.log")
    launches = {}
    reps = {}
    for impl in ("fused", "scan"):
        reps[impl], counts = cli_run(prefix, logs, impl, 1 << 14)
        launches.update({k: v for k, v in counts.items() if v})
    check(strip(reps["fused"]) == strip(reps["scan"]), "fused and scan reports differ")
    rs = aclparse.parse_config_file(os.path.join(d, "fw1.cfg"))
    with open(logs, encoding="utf-8") as fh:
        res = oracle.Oracle([rs]).consume(fh)
    rep = reps["fused"]
    got = {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"] if e["hits"]}
    check(got == dict(res.hits), "exact per-rule counts differ from the oracle")
    check([tuple(k) for k in rep["unused"]] == res.unused_rules([rs]),
          "unused rules differ from the oracle")
    check(rep["totals"]["lines_matched"] == res.lines_matched, "lines_matched != oracle")
    say(f"main path: {1 << 16} lines, 4x64 ruleset: fused == scan report; exact counts "
        f"and {len(rep['unused'])} unused rules == oracle; launches {launches}")
    return launches


def phase_full_width(work: str, card: str) -> None:
    """run over 2^20 lines against the 16x256 ruleset at batch 262144."""
    from ruleset_analysis_tpu_torch.hostside import pack, synth

    d = os.path.join(work, "full")
    os.makedirs(d, exist_ok=True)
    _, packed = ruleset(*SHAPES[1])
    prefix = os.path.join(d, "fw1")
    pack.save_packed(packed, prefix)
    logs = os.path.join(d, "fw1.log")
    t0 = time.perf_counter()
    synth.synth_syslog_file(packed, logs, FULL_B, seed=0)
    say(f"full width: synthesised {FULL_B} lines in {time.perf_counter() - t0:.1f} s")
    rep, launches = cli_run(prefix, logs, "fused", 1 << 18)
    t = rep["totals"]
    hits = sum(e["hits"] for e in rep["per_rule"])
    check(hits == t["lines_matched"], f"counts total {hits} != lines_matched {t['lines_matched']}")
    check(t["lines_total"] == FULL_B, "not every line was consumed")
    say(f"full width: {FULL_B} lines, 16x256 ruleset (Rp=7680), batch 262144, fused: "
        f"counts total == lines_matched == {hits}; lines_per_sec {t['lines_per_sec']}, "
        f"sustained_lines_per_sec {t['sustained_lines_per_sec']} (end to end, including the "
        f"pure-Python text parse) on {card}; launches {launches}")


def phase_device_step(dev, card: str) -> None:
    """The step alone at B = 2^20 wire-layout lines resident on the card."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline

    _, packed = ruleset(*SHAPES[0])
    tuples = synth.synth_tuples(packed, FULL_B, seed=3)
    wire = torch.from_numpy(pack.compact_batch(np.ascontiguousarray(tuples.T)).view(np.int32)).to(dev)
    rules = pipeline.ship_ruleset(packed, dev)
    cfg = AnalysisConfig(batch_size=FULL_B)
    steps = 8
    for impl in ("fused", "scan"):
        state = pipeline.init_state(packed.n_keys, cfg, dev)

        def step(salt):
            return pipeline.analysis_step(
                state, rules, wire, n_keys=packed.n_keys,
                topk_k=cfg.sketch.topk_chunk_candidates, salt=salt, match_impl=impl,
            )[0]

        state = step(0)  # warm-up (first use of the caching allocator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, steps + 1):
            state = step(s)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        total = pipeline.counts_total(state)
        check(total == (steps + 1) * FULL_B, f"device step counted {total} != {(steps + 1) * FULL_B}")
        say(f"device step ({impl}): B={FULL_B} wire lines, 4x64 ruleset: {dt * 1e3:.3f} ms/step, "
            f"{FULL_B / dt:.0f} lines/s on {card}; counts delta == valid lines stepped")
        if impl == "fused":
            breakdown(step, steps, dt * 1e3)


def breakdown(step, steps: int, wall_ms: float) -> None:
    """Where the step's device time goes: torch.profiler over a few steps.

    Busy time sums the device-side events only (kernels, copies, sets):
    the profiler also charges each kernel's time to the aten op that
    launched it.  The idle share is taken against the step's wall time
    measured without the profiler (`wall_ms`).
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(steps):
            step(100 + s)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        say("device step breakdown: the profiler recorded no device time (not measured)")
        return
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps  # ms per step
    launches = sum(e.count for e in events) / steps
    say(f"device step breakdown (fused, {steps} steps): device busy {busy:.3f} ms/step in "
        f"{launches:.0f} device ops/step; step wall {wall_ms:.3f} ms without the profiler, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"  {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  {e.count / steps:5.1f}x  "
            f"{e.key[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ruleset_analysis_tpu_torch")):
        print("chip_smoke: run it from a checkout (ruleset_analysis_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ruleset_analysis_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    card = f"{smi} (name, power limit)"
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    say(f"device: {smi}; torch.cuda.get_device_name: {kind}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}); nvcc: {nvcc}")
    t0 = time.perf_counter()
    spent = _build.build_all()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc; per source: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + ")")
    for name in _build.SOURCES:
        usage = [ln.strip() for ln in _build.build_log(name).splitlines() if "registers" in ln]
        say(f"ptxas {name}: {'; '.join(usage)}")

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    k = phase_kernels(dev)
    launches = phase_main_path(work)
    phase_full_width(work, card)
    phase_device_step(dev, card)

    rp_full = 7680
    src = {"first_match": ("ruleset_analysis_tpu_torch/csrc/first_match.cu",
                           "ruleset_analysis_tpu/ops/pallas_match.py:181"),
           "match_hist": ("ruleset_analysis_tpu_torch/csrc/match_hist.cu",
                          "ruleset_analysis_tpu/ops/pallas_fused.py:158")}
    kernels = []
    for name, (source, replaces) in src.items():
        row = k["rows"][(name, rp_full)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["err"][name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
