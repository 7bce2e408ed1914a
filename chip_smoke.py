#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ruleset_analysis_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (one nvcc per source, in
parallel: the match kernels, and reg_tail.cu's register tail and its
talker select), holds each against its plain torch version on the card
(bit-identical: integer outputs, tolerance 0) at the main path's shapes
and at edge shapes, drives the port's paths (`synth` -> `parse-acls` ->
`run`, over v4 and dual-stack IPv4 + IPv6 corpora, text and `.rawire`)
through the CLI with the kernels' launch counters zeroed just before
each run and read just after, checks exact counts against the port's
oracle, kills runs and resumes them from their checkpoints (the resumed
report must equal the uninterrupted one), times the device steps alone
and every register-update path (`--update-impl`, `--counts-impl`,
`--topk-every`) step by step and end to end, runs the multi-worker host
feed (`run --feed-workers N --feed-mode {process,thread,ring}`, `convert
--workers N`) against the oracle and prints each run's rate, runs the
stacked layout (`run --layout stacked --match-impl scan` over text, wire,
four firewalls' rulesets, dual-stack text, and a killed and resumed run)
against the flat scan run's registers and the oracle and prints each
run's rate and lane fill, steps the sharded step (parallel/step.py) on
meshes of 1, 2, 4 and 8 virtual shards on the card (registers equal to
one shard's, registers and candidates equal to the same mesh's plain
versions on the CPU; ms a step and the merge's ms), runs `run
--distributed` as a one-rank NCCL job in a process of its own against
the plain run's report, holds the static analysis's relation_grid kernel
(the relation_tile row of the kernels line) to its plain version on edge
tiles and on the analyzer's work lists and runs `analyze` (on the card
against `--device cpu`, over three rulesets, one relation_grid launch
each), `run --static-analysis` and a fired `analyze.tile` fault (no
launch) through the CLI, drives the run path's failure handling on the
16x256 text corpus (`run --fault-plan` recovered by the device_put and
checkpoint.save retries to the clean report, an exhausted plan's
postmortem read by `doctor`, `--trace-out`, and the rate with the flight
recorder on against `--blackbox off`), drives the run's telemetry
(`run --metrics-out` JSONL on the synchronous loop, at prefetch 2 and
through the ring feeder, checkpoint events, a postmortem's gauges, a
`--profile-dir` trace's kernel records against the launches, and the
rate with each against the default run), runs `run --distributed
--elastic` with one member on a one-rank NCCL group (a clean run against
the plain run, a generation failed after its second epoch and re-formed
to the uninterrupted registers, and an exhausted `--max-reforms 0` with
its postmortem read by `doctor`), runs `run --distributed --elastic
--autoscale` with two launchers, one active on the card and one a warm
standby (a scripted observe-only decision logged and not acted on, the
report and registers the plain run's; an observe-only run at the default
policy over the shards 16 times over, whose signal series, the one the
autoscaler reads, spans several sustain windows; the active launcher
killed past its first epoch and the standby finishing from the epoch to
the uninterrupted registers), captures bounded `run --devprof-out` windows
(default, fused, stacked and dual-stack runs: each armed report
equal to the disarmed one, the card's time attributed to the `ra.*`
stages, each hand kernel's trace records against its launches, the rate
armed against disarmed),
and prints one JSON line per the format below.  Every failure raises, so the exit code is nonzero; with
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
#: the same for a v6 test: 1 acl compare, 3 scalar ranges x 2, four
#: 128-bit bounds x 4 (a four-limb subtract-with-borrow chain each), 1
#: select
OPS_PER_TEST6 = 24
#: share of IPv6 ACEs (and log lines) of the dual-stack configuration
V6_FRACTION = 0.3

FULL_B = 1 << 20
#: (n_acls, rules_per_acl) of the two realistic rulesets: the repo's
#: one-ruleset bench geometry (Rp = 512) and a large edge ruleset (Rp = 7680)
SHAPES = ((4, 64), (16, 256))
#: the ingest phase's text corpus and its straight-to-wire corpus
INGEST_TEXT_LINES = 1 << 21
INGEST_WIRE_ROWS = 1 << 24
#: the resume phase's v4 text corpus and batch: 16 chunks
RESUME_LINES = 1 << 20
RESUME_B = 1 << 16
#: the batch of its dual-stack wire runs (the dual-stack phase's 2^20-line files)
RESUME_B6 = 1 << 18
#: the stacked phase's batch: 2^18 lines over 16 ACLs, a lane of 2^14
STACKED_B = 1 << 18
#: integer operations a valid line of the reg_tail kernel, atomics apart
#: (counted from csrc/reg_tail.cu): the weight test 1, hash_pair and the
#: gid tag 21, the CMS mix 9, the row -> key lookup and range test 6, the
#: HLL's two fmix32 and rank and cell 25, the sample test and slot hash 15;
#: then 4 a talker-CMS depth row, and 10 for a v6 source's limb fold
OPS_TAIL_LINE = 77
OPS_TAIL_ROW = 4
OPS_TAIL_FOLD = 10


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """SM clock, power draw and temperature now, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
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


def ruleset(n_acls: int, rules_per_acl: int, v6_fraction: float = 0.0):
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth

    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=0,
                              v6_fraction=v6_fraction)
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
        rp = r.rules_k.shape[0]
        tuples = synth.synth_tuples(packed, FULL_B, seed=1)
        f = line_fields(tuples, dev)
        fields, valid = f[:6], f[6]

        got = first_match.first_match_rows(fields, r.rules_k, r.acl_span)
        torch.cuda.synchronize()
        want = first_match.first_match_rows_plain(fields, r.rules_k, r.acl_span)
        e = max_abs_err([got], [want])
        check(e == 0, f"first_match != plain at B={FULL_B} Rp={rp} (max abs err {e})")
        err["first_match"] = max(err["first_match"], e)
        for glob in (False, True):
            got2 = match_hist.match_rows_and_hists(fields, valid, r.rules_k, r.acl_span,
                                                   packed.n_acls, force_global=glob)
            torch.cuda.synchronize()
            want2 = match_hist.match_rows_and_hists_plain(fields, valid, r.rules_k, r.acl_span,
                                                          packed.n_acls)
            e2 = max_abs_err(got2, want2)
            check(e2 == 0, f"match_hist (global_mode={glob}) != plain at B={FULL_B} Rp={rp}")
            err["match_hist"] = max(err["match_hist"], e2)
        say(f"kernels: B={FULL_B} Rp={rp} n_acls={packed.n_acls}: first_match and "
            "match_hist (shared and global-atomic modes) bit-identical to plain "
            "(tolerance 0)")

        # the bound: bytes each input read once and each output written
        # once, and the rule tests this data needs.  A line needs only
        # its own ACL's rows (they are contiguous in config order), up to
        # its first hit, or all of them when none matches.  The kernels
        # walk a line's span 32 rows per warp step (`steps`), and a warp
        # takes its 32 lines one after another.
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
        s_first, s_end = first_match.line_spans(a64, r.acl_span, rp)
        steps = int(torch.where(matched, (r64 - s_first) // 32 + 1,
                                (s_end - s_first + 31) // 32).sum())
        ops = OPS_PER_TEST * tests
        b_in = 24 * FULL_B + 4 * 12 * rp + r.acl_span.numel() * 4
        b1 = b_in + 4 * FULL_B
        b2 = b_in + 4 * FULL_B + 4 * FULL_B + 4 * (rp + match_hist.acl_pad(packed.n_acls))
        ops2 = ops + int(valid.to(torch.int64).sum())
        args = (fields, r.rules_k, r.acl_span)
        hargs = (fields, valid, r.rules_k, r.acl_span, packed.n_acls)
        # three rounds of 20 launches each, the kernels in turns; the median
        timed = {"first_match": lambda: first_match.first_match_rows(*args),
                 "match_hist": lambda: match_hist.match_rows_and_hists(*hargs),
                 "global": lambda: match_hist.match_rows_and_hists(*hargs, force_global=True)}
        rounds = {k: [] for k in timed}
        for _ in range(3):
            for k, fn in timed.items():
                rounds[k].append(cuda_ms(fn, 20))
        clocks = gpu_clocks()
        ms1, ms2, ms2g = (sorted(v)[1] for v in rounds.values())
        p1 = cuda_ms(lambda: first_match.first_match_rows_plain(*args), 2, warmup=1)
        p2 = cuda_ms(lambda: match_hist.match_rows_and_hists_plain(*hargs), 2, warmup=1)
        for name, ms, plain, nbytes, nops in (
            ("first_match", ms1, p1, b1, ops), ("match_hist", ms2, p2, b2, ops2),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_SEC * 1e3
            t_ops = nops / INT32_OPS_PER_SEC * 1e3
            bound = max(t_bytes, t_ops)
            rows[(name, rp)] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            say(f"kernel {name}: B={FULL_B} Rp={rp}: {ms:.4f} ms/launch (plain torch "
                f"{plain:.2f} ms), bound {bound:.4f} ms by {rows[(name, rp)]['bound_by']}, "
                f"share of bound {bound / ms:.3f} ({tests / FULL_B:.1f} rule tests/line needed, "
                f"{steps / FULL_B:.2f} warp steps/line walked, {32 * steps / FULL_B:.1f} "
                f"row tests/line issued)")
        say(f"kernel match_hist global-atomic mode: B={FULL_B} Rp={rp}: {ms2g:.4f} ms/launch")
        say(f"kernel rounds at Rp={rp} (ms/launch, 20 launches each): "
            + "; ".join(f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in rounds.items())
            + f"; after them nvidia-smi clocks.sm, power.draw, temperature: {clocks}")

    # edge shapes: a batch that is not a multiple of the block, all-invalid
    # lines, acl ids >= n_acls (clamped onto the last ACL's deny key), and
    # synth.match_edge_cases: interleaved ACLs, spans that are not
    # multiples of 32, ACLs with no rows, one ACL of 7680 rows, a batch
    # unmatched in a 7000-row ACL, NO_ACL zero-field lines
    _, packed = ruleset(*SHAPES[0])
    r = pipeline.ship_ruleset(packed, dev)
    tuples = synth.synth_tuples(packed, 100003, seed=2)
    tuples[::13, 0] = np.uint32(packed.n_acls + 3)
    tuples[::29, 0] = np.uint32(0xFFFFFFF0)
    tuples[::7, 6] = 0
    f = line_fields(tuples, dev)
    cases = {
        "ragged B=100003 with corrupt acls": (r.rules_k, r.acl_span, packed.n_acls, f[:6], f[6]),
        "all-invalid lines": (r.rules_k, r.acl_span, packed.n_acls, f[:6], torch.zeros_like(f[6])),
        "one line": (r.rules_k, r.acl_span, packed.n_acls, [x[:1].clone() for x in f[:6]],
                     f[6][:1].clone()),
    }
    first_pad = {}
    for name, (rules, tuples, n_acls) in synth.match_edge_cases(n=100003, seed=4).items():
        rk = first_match.prep_rules(torch.from_numpy(
            pipeline.pad_rules(rules).astype(np.int64)).to(dev))
        f = line_fields(tuples, dev)
        cases[name] = (rk, first_match.acl_spans(rk), n_acls, f[:6], f[6])
        if rk.shape[0] > rules.shape[0] and (tuples[7::31, 0] == 0xFFFFFFFF).all():
            first_pad[name] = rules.shape[0]
    for what, (rk, span, n_acls, fields, valid) in cases.items():
        want = first_match.first_match_rows_plain(fields, rk, span)
        e = max_abs_err([first_match.first_match_rows(fields, rk, span)], [want])
        check(e == 0, f"first_match != plain on {what}")
        if what in first_pad:  # NO_ACL zero-field lines take the first padding row
            check(bool((u32_of(want[7::31]) == first_pad[what]).all()),
                  f"NO_ACL zero-field lines missed the first padding row on {what}")
        if what.startswith("every line unmatched"):
            check(bool((want == -1).all()), f"a line matched on {what}")
        for glob in (False, True):
            got = match_hist.match_rows_and_hists(fields, valid, rk, span, n_acls,
                                                  force_global=glob)
            want2 = match_hist.match_rows_and_hists_plain(fields, valid, rk, span, n_acls)
            e2 = max_abs_err(got, want2)
            check(e2 == 0, f"match_hist (global_mode={glob}) != plain on {what}")
        torch.cuda.synchronize()
        say(f"kernels: edge shape {what}: bit-identical to plain")
    return {"rows": rows, "err": err}


def registers6() -> str:
    """"N registers, <spills>" of the first_match6 kernel, from the build's
    ``-Xptxas -v`` log."""
    from ruleset_analysis_tpu_torch.ops import _build

    log = [ln.strip() for ln in _build.build_log("first_match6").splitlines()]
    used = [ln for ln in log if "Used" in ln and "registers" in ln]
    spills = [ln for ln in log if "spill" in ln]
    if not used:
        return "registers not in the build log"
    regs = used[0].split("Used ")[1].split(",")[0]
    return f"{regs}, {spills[0] if spills else 'spills not reported'}"


def phase_kernel6(dev) -> dict:
    """first_match6 vs its plain version; time and bound at B = 2^20 on the
    16x256 dual-stack ruleset, then the edge shapes and all three layouts."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops import first_match, first_match6
    from ruleset_analysis_tpu_torch.ops.hashing import u32_of
    from ruleset_analysis_tpu_torch.ops.match import NO_MATCH
    from ruleset_analysis_tpu_torch.ops.match6 import FIELDS6

    def fields6(batch):
        cols, _ = pipeline.batch_cols6(batch)
        return [cols[k] for k in FIELDS6]

    _, packed = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
    r6 = pipeline.ship_ruleset6(packed, dev)
    rp6 = r6.rules_k6.shape[0]
    t6 = synth.synth_tuples6(packed, FULL_B, seed=1)
    t = np.ascontiguousarray(t6.T)
    w = pack.compact_batch6(t)
    layouts = {"tuple": t, "wire": w,
               "weighted wire": np.concatenate([w, t[-1:]])}
    err = 0
    for name, arr in layouts.items():
        f = fields6(torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(dev))
        got = first_match6.first_match_rows6(f, r6.rules_k6, r6.acl_span6)
        torch.cuda.synchronize()
        want = first_match6.first_match_rows6_plain(f, r6.rules_k6, r6.acl_span6)
        e = max_abs_err([got], [want])
        check(e == 0, f"first_match6 != plain at B={FULL_B} R6p={rp6}, {name} layout")
        err = max(err, e)
    say(f"kernels: B={FULL_B} R6p={rp6} ({packed.rules6.shape[0]} v6 rows, "
        f"{packed.rules.shape[0]} v4 rows): first_match6 bit-identical to plain (tolerance 0) "
        "on the tuple, wire and weighted-wire layouts")

    # the bound, as for v4: each input read once, each output written
    # once, and the rule tests this data needs (a line's own ACL's v6 rows
    # up to its first hit, all of them when none matches)
    fields = fields6(torch.from_numpy(t.view(np.int32)).to(dev))
    args = (fields, r6.rules_k6, r6.acl_span6)
    want = first_match6.first_match_rows6_plain(*args)
    r64, a64 = u32_of(want), u32_of(fields[0])
    acl_col = torch.from_numpy(packed.rules6[:, 0].astype(np.int64)).to(dev)
    own = acl_col < packed.n_acls
    n_rows = torch.bincount(acl_col[own], minlength=packed.n_acls)
    first = torch.full((packed.n_acls,), packed.rules6.shape[0], dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, acl_col[own], torch.nonzero(own).flatten(), "amin")
    known = a64 < packed.n_acls
    a_c = torch.clamp(a64, max=packed.n_acls - 1)
    matched = r64 != NO_MATCH
    tests = int(torch.where(matched, r64 - first[a_c] + 1,
                            torch.where(known, n_rows[a_c], 0)).sum())
    # steps of a G-lane group: G rows of the span a step up to the first
    # hit, the whole span (at least one step) else
    g = first_match6.GROUP
    s_first, s_end = first_match.line_spans(a64, r6.acl_span6, rp6)
    steps = int(torch.where(matched, (r64 - s_first) // g + 1,
                            torch.clamp((s_end - s_first + g - 1) // g, min=1)).sum())
    nbytes = 48 * FULL_B + 4 * FULL_B + 96 * rp6 + r6.acl_span6.numel() * 4
    nops = OPS_PER_TEST6 * tests
    rounds = [cuda_ms(lambda: first_match6.first_match_rows6(*args), 20) for _ in range(3)]
    ms = sorted(rounds)[1]
    plain = cuda_ms(lambda: first_match6.first_match_rows6_plain(*args), 2, warmup=1)
    t_bytes = nbytes / HBM_BYTES_PER_SEC * 1e3
    t_ops = nops / INT32_OPS_PER_SEC * 1e3
    bound = max(t_bytes, t_ops)
    row = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    say(f"kernel first_match6: B={FULL_B} R6p={rp6}: {ms:.4f} ms/launch (plain torch "
        f"{plain:.2f} ms), bound {bound:.4f} ms by {row['bound_by']}, share of bound "
        f"{bound / ms:.3f} ({tests / FULL_B:.2f} rule tests/line needed, {steps / FULL_B:.3f} "
        f"group steps/line of G={g} lanes, {steps * g / 32 / FULL_B:.3f} warp steps/line; "
        f"{registers6()}); rounds " + " ".join(f"{x:.4f}" for x in rounds)
        + f"; nvidia-smi clocks.sm, power.draw, temperature: {gpu_clocks()}")

    for name, (rules6, tup) in synth.match6_edge_cases(n=100003, seed=4).items():
        rk = first_match6.prep_rules6(torch.from_numpy(
            pipeline.pad_rules6(rules6).astype(np.int64)).to(dev))
        span = first_match.acl_spans(rk)
        f = fields6(torch.from_numpy(np.ascontiguousarray(tup.T).view(np.int32)).to(dev))
        want = first_match6.first_match_rows6_plain(f, rk, span)
        e = max_abs_err([first_match6.first_match_rows6(f, rk, span)], [want])
        torch.cuda.synchronize()
        check(e == 0, f"first_match6 != plain on {name}")
        if name.startswith("ragged"):  # NO_ACL zero-field lines take the first padding row
            check(bool((u32_of(want[7::31]) == rules6.shape[0]).all()),
                  "NO_ACL zero-field v6 lines missed the first padding row")
        if name.startswith("an ACL with no"):
            check(bool((want[torch.from_numpy(tup[:, 0] == 1).to(dev)] == -1).all()),
                  "a line of an ACL with no v6 rows matched")
        if name.startswith("every line unmatched"):
            check(bool((want == -1).all()), f"a line matched on {name}")
        say(f"kernels: v6 edge shape {name} (B={tup.shape[0]}, R6p={rk.shape[0]}): "
            "bit-identical to plain")
    return {"row": row, "err": err}


def cli_run(prefix: str, logs, impl: str | None, batch: int, extra: tuple = (),
            tag: str = "", chunks_before: int = 0) -> tuple[dict, dict]:
    """One `run` through the CLI with the launch counters zeroed around it.

    ``impl``: the ``--match-impl`` to pass, or None for the default (scan).
    ``chunks_before``: chunks a resumed run's snapshot already holds (its
    ``totals.chunks`` is cumulative; only the rest launch)."""
    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.ops import first_match, first_match6, match_hist, reg_tail

    logs = [logs] if isinstance(logs, str) else list(logs)
    name = impl or "default"
    out = os.path.join(os.path.dirname(logs[0]), f"report-{name}-{batch}{tag}.json")
    counters = {"first_match": first_match.first_match_rows,
                "match_hist": match_hist.match_rows_and_hists,
                "first_match6": first_match6.first_match_rows6,
                "reg_tail": reg_tail.reg_tail, "select": reg_tail.select_tables}
    for fn in counters.values():
        fn.launches = 0
    rc = cli.main(["run", "--ruleset", prefix, "--logs", *logs,
                   *(("--match-impl", impl) if impl else ()),
                   "--batch-size", str(batch), "--json", "--out", out, *extra])
    launches = {k: fn.launches for k, fn in counters.items()}
    check(rc == 0, f"cli run --match-impl {name} {' '.join(extra)} exited {rc}")
    with open(out, encoding="utf-8") as fh:
        rep = json.load(fh)
    check(rep["totals"]["backend"] == "torch-cuda", "the run did not use the CUDA device")
    want = "match_hist" if impl == "fused" else "first_match"
    other = "first_match" if impl == "fused" else "match_hist"
    # every chunk is a v4 chunk (the v4 kernel) or a v6 chunk (first_match6):
    # no CUDA batch reached a plain scan
    check(launches[want] + launches["first_match6"] == rep["totals"]["chunks"] - chunks_before
          and launches[want] + launches["first_match6"] > 0,
          f"--match-impl {name}: {want} launched {launches[want]} and first_match6 "
          f"{launches['first_match6']} times over {rep['totals']['chunks']} chunks "
          f"({chunks_before} before a resume)")
    check(launches[other] == 0, f"--match-impl {name} launched {other}")
    # every chunk's tail ran the reg_tail kernel (under every update-path
    # flag), and every selecting chunk the select kernel
    stepped = rep["totals"]["chunks"] - chunks_before
    check(launches["reg_tail"] == stepped,
          f"reg_tail launched {launches['reg_tail']} times over {stepped} chunks "
          f"({' '.join(extra)})")
    check(0 < launches["select"] <= stepped,
          f"select launched {launches['select']} times over {stepped} chunks")
    return rep, launches


def strip(rep: dict) -> dict:
    from ruleset_analysis_tpu_torch.runtime.report import VOLATILE_TOTALS

    rep = json.loads(json.dumps(rep))
    for k in VOLATILE_TOTALS:
        rep["totals"].pop(k, None)
    return rep


def phase_main_path(work: str) -> dict:
    """synth -> parse-acls -> run, the default (scan) and fused, exact vs the oracle."""
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
    for impl in (None, "fused"):
        reps[impl], counts = cli_run(prefix, logs, impl, 1 << 14)
        launches.update({k: v for k, v in counts.items() if v})
    check(strip(reps[None]) == strip(reps["fused"]), "default (scan) and fused reports differ")
    rs = aclparse.parse_config_file(os.path.join(d, "fw1.cfg"))
    with open(logs, encoding="utf-8") as fh:
        res = oracle.Oracle([rs]).consume(fh)
    rep = reps[None]
    got = {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"] if e["hits"]}
    check(got == dict(res.hits), "exact per-rule counts differ from the oracle")
    check([tuple(k) for k in rep["unused"]] == res.unused_rules([rs]),
          "unused rules differ from the oracle")
    check(rep["totals"]["lines_matched"] == res.lines_matched, "lines_matched != oracle")
    say(f"main path: {1 << 16} lines, 4x64 ruleset: default (scan) == fused report; exact counts "
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
    rep, launches = cli_run(prefix, logs, None, 1 << 18)
    t = rep["totals"]
    hits = sum(e["hits"] for e in rep["per_rule"])
    check(hits == t["lines_matched"], f"counts total {hits} != lines_matched {t['lines_matched']}")
    check(t["lines_total"] == FULL_B, "not every line was consumed")
    say(f"full width: {FULL_B} lines, 16x256 ruleset (Rp=7680), batch 262144, default (scan), "
        f"default parse (native) and prefetch depth {t['ingest']['prefetch_depth']}: "
        f"counts total == lines_matched == {hits}; lines_per_sec {t['lines_per_sec']}, "
        f"sustained_lines_per_sec {t['sustained_lines_per_sec']} (end to end) on {card}; "
        f"launches {launches}")


def oracle_hits(rs, parsed_counts) -> dict:
    """Exact per-rule hits from the port's oracle: (ParsedLine, multiplicity) pairs."""
    from collections import Counter

    from ruleset_analysis_tpu_torch.hostside import oracle

    orc = oracle.Oracle(rs if isinstance(rs, list) else [rs])
    hits = Counter()
    for p, c in parsed_counts:
        for key in ([] if p is None else orc.match_keys(p)):
            hits[key] += c
    return dict(hits)


def report_hits(rep: dict) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"] if e["hits"]}


def ingest_line(what: str, rep: dict, card: str, extra: str = "") -> None:
    from ruleset_analysis_tpu_torch.hostside import fastparse

    t = rep["totals"]
    raw_rate = t["lines_total"] / max(t["elapsed_sec"] - t["compile_sec"], 1e-9)
    say(f"ingest {what}: sustained_lines_per_sec {t['sustained_lines_per_sec']} "
        f"(raw lines/s {raw_rate:.1f}), lines_total {t['lines_total']}, chunks {t['chunks']}, "
        f"elapsed_sec {t['elapsed_sec']}, compile_sec {t['compile_sec']}, "
        f"totals.ingest {json.dumps(t.get('ingest'))}, "
        f"parse threads {fastparse.default_parse_threads()}, simd {fastparse.simd_kind()}"
        f"{extra}; on {card}")


def h2d_rates(dev) -> str:
    """Host-to-card copy rates of one 2^20-line wire batch (16 MiB): the
    host copy into a pinned buffer, the pinned buffer's DMA to the card
    alone, the two together as the prefetch ring does them, and a
    pageable ``.to(cuda)``."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.runtime.ingest import H2DRing

    arr = np.random.default_rng(0).integers(0, 1 << 32, size=(4, FULL_B), dtype=np.uint32)
    n, gb = 20, arr.nbytes * 20 / 1e9
    ring = H2DRing(dev, 4)
    for _ in range(4):
        ring.put(arr).use()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record(ring.stream)
    for _ in range(n):
        ring.put(arr)
    e1.record(ring.stream)
    torch.cuda.synchronize()
    ring_wall = time.perf_counter() - t0
    pinned = torch.empty(arr.shape, dtype=torch.int32, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(n):
        np.copyto(pinned.numpy(), arr.view(np.int32))
    memcpy = gb / (time.perf_counter() - t0)
    out = torch.empty(arr.shape, dtype=torch.int32, device=dev)
    with torch.cuda.stream(ring.stream):
        out.copy_(pinned, non_blocking=True)
        e0.record(ring.stream)
        for _ in range(n):
            out.copy_(pinned, non_blocking=True)
        e1.record(ring.stream)
    torch.cuda.synchronize()
    dma = gb / (e0.elapsed_time(e1) / 1e3)
    host = torch.from_numpy(arr.view(np.int32))
    t0 = time.perf_counter()
    for _ in range(n):
        host.to(dev)
    torch.cuda.synchronize()
    pageable = gb / (time.perf_counter() - t0)
    return (f"H2D of a 16 MiB wire batch, {n} times: host copy into a pinned buffer "
            f"{memcpy:.2f} GB/s (host clock); pinned -> card DMA alone {dma:.2f} GB/s (CUDA "
            f"events); the ring's put (both) {gb / ring_wall:.2f} GB/s (host clock); "
            f"pageable .to(cuda) {pageable:.2f} GB/s (host clock)")


def phase_ingest(work: str, dev, card: str) -> dict:
    """The ingest tier on the 16x256 ruleset: native text, plain and 2^24-row
    wire, weighted wire; each run's report held against the oracle."""
    from collections import Counter

    import numpy as np

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.hostside import aclparse, fastparse, pack, synth, wire
    from ruleset_analysis_tpu_torch.hostside.syslog import ParsedLine, parse_line

    d = os.path.join(work, "ingest")
    os.makedirs(d, exist_ok=True)
    text, packed = ruleset(*SHAPES[1])
    rs = aclparse.parse_asa_config(text, "fw1")
    prefix = os.path.join(d, "fw1")
    pack.save_packed(packed, prefix)
    launches = Counter()

    # (a) a 2^21-line text corpus of repeated flows (Zipf 1.0 over a pool
    # of 2^16), rendered as 106100 lines; the oracle reads each distinct
    # line once, with its multiplicity
    n_text, chunk = INGEST_TEXT_LINES, 1 << 18
    logs = os.path.join(d, "fw1.log")
    pool, idx = synth.flow_draws(packed, n_text, 1 << 16, skew=1.0, seed=11)
    line_counts = Counter()
    t0 = time.perf_counter()
    with open(logs, "w", encoding="utf-8") as f:
        for i in range(0, n_text, chunk):
            lines = synth.render_syslog(packed, pool[idx[i:i + chunk]], seed=11 + i)
            line_counts.update(lines)
            f.write("\n".join(lines) + "\n")
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = oracle_hits(rs, ((parse_line(ln), c) for ln, c in line_counts.items()))
    say(f"ingest: synthesised {n_text} text lines ({len(line_counts)} distinct) in "
        f"{t_synth:.1f} s; oracle over them in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_parsed = sum(n for _, n in fastparse.batches_from_files(
        [logs], fastparse.NativePacker(packed), 1 << 18))
    t_parse = time.perf_counter() - t0
    check(n_parsed == n_text, f"native parse read {n_parsed} lines of {n_text}")
    say(f"ingest: native parse alone (batches_from_files, 2^18 lines a batch, no device): "
        f"{n_text / t_parse:.1f} lines/s with {fastparse.default_parse_threads()} threads, "
        f"simd {fastparse.simd_kind()}, on the host of {card}")

    runs = {}
    for name, impl, logs_, batch, extra in (
        ("text native, prefetch 2", None, logs, 1 << 18,
         ("--native-parse", "--prefetch-depth", "2")),
        ("text python, prefetch 0", None, logs, 1 << 18,
         ("--no-native-parse", "--prefetch-depth", "0")),
    ):
        runs[name], n = cli_run(prefix, logs_, impl, batch, extra, tag=f"-{len(runs)}")
        launches.update(n)
        ingest_line(name, runs[name], card)
    a, a_py = runs["text native, prefetch 2"], runs["text python, prefetch 0"]
    check(strip(a) == strip(a_py), "native/prefetch and python/synchronous reports differ")
    check(report_hits(a) == want, "text run: exact counts differ from the oracle")
    check(a["totals"]["lines_total"] == n_text, "text run did not consume every line")

    # (b) plain wire: the corpus converted, and 2^24 rows written straight
    # from flow tuples (no text); both run at B = 2^20 on the default route
    plain = os.path.join(d, "fw1.rawire")
    t0 = time.perf_counter()
    check(cli.main(["convert", "--ruleset", prefix, "--logs", logs, "--out", plain,
                    "--native-parse", "--block-rows", str(FULL_B)]) == 0, "convert failed")
    say(f"ingest: convert (native) of {n_text} lines in {time.perf_counter() - t0:.1f} s")
    n_big = INGEST_WIRE_ROWS
    big = os.path.join(d, "big.rawire")
    t0 = time.perf_counter()
    bpool, bidx = synth.flow_draws(packed, n_big, 1 << 14, skew=1.0, seed=12)
    with wire.WireWriter(big, wire.ruleset_fingerprint(packed), FULL_B) as w:
        for i in range(0, n_big, FULL_B):
            rows = np.ascontiguousarray(bpool[bidx[i:i + FULL_B]].T)
            w.add(pack.compact_batch(rows), FULL_B, 0)
    gid_name = {gid: acl for (_, acl), gid in packed.acl_gid.items()}
    mult = np.bincount(bidx, minlength=bpool.shape[0])
    want_big = oracle_hits(rs, (
        (ParsedLine(firewall="fw1", acl=gid_name[int(t[0])], ingress_if=None,
                    proto=int(t[1]), src=int(t[2]), sport=int(t[3]), dst=int(t[4]),
                    dport=int(t[5]), permitted=None), int(c))
        for t, c in zip(bpool, mult) if c
    ))
    say(f"ingest: wrote {n_big} wire rows ({bpool.shape[0]} distinct flows) and their "
        f"oracle counts in {time.perf_counter() - t0:.1f} s")
    for name, path_, want_ in (("plain wire (converted)", plain, want),
                               ("plain wire 2^24 rows", big, want_big)):
        runs[name], n = cli_run(prefix, path_, None, FULL_B, tag=f"-{len(runs)}")
        launches.update(n)
        check(report_hits(runs[name]) == want_, f"{name}: exact counts differ from the oracle")
        ingest_line(name, runs[name], card)
    check(strip(runs["plain wire (converted)"])["per_rule"] == strip(a)["per_rule"],
          "plain wire run differs from the text run")

    # (c) weighted wire: the corpus converted with --coalesce, run on the
    # default route (match_hist is refused for weighted rows)
    wfile = os.path.join(d, "fw1-w.rawire")
    check(cli.main(["convert", "--ruleset", prefix, "--logs", logs, "--out", wfile,
                    "--native-parse", "--coalesce", "--block-rows", str(1 << 18)]) == 0,
          "convert --coalesce failed")
    name = "weighted wire, scan"
    runs[name], n = cli_run(prefix, wfile, None, 1 << 18, tag=f"-{len(runs)}")
    launches.update(n)
    c = runs[name]
    t = c["totals"]
    ingest_line(name, c, card, f", {t['wire_rows']} stored rows for {t['wire_evals']} "
                f"evaluations (compaction {t['wire_evals'] / t['wire_rows']:.2f}x)")
    sc, sa = strip(c), strip(a)
    for k in ("wire_rows", "wire_evals", "wire_weighted"):
        sc["totals"].pop(k, None)
    for k in ("chunks",):  # stored rows re-chunk: fewer, fuller chunks
        sc["totals"].pop(k)
        sa["totals"].pop(k)
    check(sc["per_rule"] == sa["per_rule"] and sc["unused"] == sa["unused"]
          and sc["totals"] == sa["totals"], "weighted wire report differs from the text run")
    say(f"ingest: weighted report == text report (per-rule hits and unique sources, unused, "
        f"totals but chunks); talker lists {'equal' if sc['talkers'] == sa['talkers'] else 'differ'} "
        "(per-chunk candidates follow the chunking, which coalescing changes)")
    say("ingest: " + h2d_rates(dev) + f"; on {card}")
    say(f"ingest: launches over the ingest runs {dict(launches)}")
    return dict(launches), {"rs": rs, "prefix": prefix, "logs": logs, "want": want}


def oracle_unused(rs, hits: dict) -> list:
    """The configured rules with no oracle hit, in configuration order
    (``rs``: one ruleset, or a list of them in packing order)."""
    return [(r_.firewall, acl, r.index) for r_ in (rs if isinstance(rs, list) else [rs])
            for acl, rules in r_.acls.items() for r in rules
            if not hits.get((r_.firewall, acl, r.index))]


def feed_line(what: str, rep: dict, card: str) -> None:
    t = rep["totals"]
    ing = t.get("ingest") or {}
    say(f"feeder {what}: sustained_lines_per_sec {t['sustained_lines_per_sec']}, "
        f"lines_per_sec {t['lines_per_sec']}, chunks {t['chunks']}, elapsed_sec "
        f"{t['elapsed_sec']}, totals.ingest starved_sec {ing.get('starved_sec')} "
        f"backpressure_sec {ing.get('backpressure_sec')} produce_sec {ing.get('produce_sec')}; "
        f"os.cpu_count() {os.cpu_count()}; on {card}")


def copy_routes(prefix: str, logs: str, batch: int, dev, card: str, reps: int = 20) -> None:
    """Host seconds a batch takes from its feeder slot into the pinned ring,
    by the two routes the loop has, on one ring feeder batch: the ring's
    views bit-packed straight into the pinned buffer (`put_views`), and
    the process mode's (the slot copied out, `compact_batch`, `put`).  In
    turns; the card's copy of each is held to the packed batch."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside import feeder, pack
    from ruleset_analysis_tpu_torch.runtime.ingest import H2DRing

    src = feeder.RingFeeder(pack.load_packed(prefix), [logs], n_workers=4, n_rings=1)
    src.emit_views = True
    gen = src.batches(0, batch)
    try:
        rb, _ = next(gen)
        time.sleep(0.5)  # the workers fill the other slots and go idle
        want = torch.from_numpy(pack.compact_batch(np.concatenate(rb.views, axis=1))
                                .view(np.int32))
        ring = H2DRing(dev, 2)
        secs = {"direct": [], "assembled": []}
        for k in range(2 * reps):
            route = ("direct", "assembled")[k % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "direct":
                db = ring.put_views(rb.views)
            else:
                db = ring.put(pack.compact_batch(np.concatenate(rb.views, axis=1)))
            secs[route].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            if k < 2:
                check(torch.equal(db.tensor.cpu(), want), f"copy route {route}: wrong batch")
        rb.release()
    finally:
        gen.close()
    med = {r: sorted(v)[len(v) // 2] * 1e3 for r, v in secs.items()}
    say(f"feeder: slot -> pinned ring, batch {batch} ({want.numel() * 4} B packed), median of "
        f"{reps} in turns: direct view copy {med['direct']:.4f} ms, assembled (slot copy + "
        f"compact + put) {med['assembled']:.4f} ms, ratio "
        f"{med['assembled'] / med['direct']:.3f}; host clock; on {card}")


def phase_feeder(work: str, dev, card: str, ing: dict) -> dict:
    """The multi-worker host feed on the ingest phase's 16x256 ruleset and
    2^21-line text corpus at batch 2^18: --feed-workers 0/2/4/8 (process),
    4 (thread, ring), each run's counts and unused set == the oracle, the
    three modes' reports equal; over the corpus four times, off, process
    x4 and ring x4 in turns, process x8 and thread x8, and the host time
    of the two slot-to-pinned copy routes (`copy_routes`); a dual-stack
    ring run against its oracle;
    `convert --workers 4` whose manifest run equals the single-file
    `convert --coalesce` run."""
    from collections import Counter

    import numpy as np

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth
    from ruleset_analysis_tpu_torch.hostside.syslog import parse_line

    rs, prefix, logs, want = ing["rs"], ing["prefix"], ing["logs"], ing["want"]
    unused = oracle_unused(rs, want)
    batch = 1 << 18
    launches = Counter()
    reps = {}
    say(f"feeder: host of {card}: os.cpu_count() {os.cpu_count()}, usable cores "
        f"{len(os.sched_getaffinity(0))}")
    for i, (mode, workers) in enumerate((("process", 0), ("process", 2), ("process", 4),
                                         ("process", 8), ("thread", 4), ("ring", 4))):
        rep, n = cli_run(prefix, logs, "fused", batch,
                         ("--feed-workers", str(workers), "--feed-mode", mode),
                         tag=f"-feed{i}")
        launches.update(n)
        check(report_hits(rep) == want, f"feeder {mode} x{workers}: counts != oracle")
        check([tuple(k) for k in rep["unused"]] == unused,
              f"feeder {mode} x{workers}: unused != oracle")
        check(rep["totals"]["lines_total"] == INGEST_TEXT_LINES,
              f"feeder {mode} x{workers}: not every line was consumed")
        feed_line(f"{mode} x{workers} (run {i})", rep, card)
        reps.setdefault((mode, workers), []).append(rep)
    modes = [strip(reps[m, 4][0]) for m in ("process", "thread", "ring")]
    check(modes[0] == modes[1] == modes[2], "process, thread and ring reports differ")
    say(f"feeder: process, thread and ring x4 reports identical; counts and "
        f"{len(unused)} unused rules == oracle in every run; launches {dict(launches)}")
    # the corpus listed four times (2^23 lines): the workers' start-up
    # (spawned interpreters) spread over four times the parse; process x4
    # and ring x4 in turns, for the ring's direct view copy
    want4 = {k: 4 * v for k, v in want.items()}
    for i, (mode, workers) in enumerate((("process", 0), ("process", 4), ("ring", 4),
                                         ("ring", 4), ("process", 4), ("process", 8),
                                         ("thread", 8))):
        rep, n = cli_run(prefix, [logs] * 4, "fused", batch,
                         ("--feed-workers", str(workers), "--feed-mode", mode),
                         tag=f"-feedx4-{i}")
        launches.update(n)
        check(report_hits(rep) == want4, f"feeder {mode} x{workers} over 2^23 lines: counts")
        feed_line(f"{mode} x{workers}, the corpus four times ({4 * INGEST_TEXT_LINES} lines, "
                  f"run {i})", rep, card)
    copy_routes(prefix, logs, batch, dev, card)

    # dual-stack: 2^20 lines drawn (Zipf 1.0) from 2^16 distinct lines, 30% IPv6
    d = os.path.join(work, "feed6")
    os.makedirs(d, exist_ok=True)
    text6, packed6 = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
    rs6 = aclparse.parse_asa_config(text6, "fw1")
    prefix6 = os.path.join(d, "fw1")
    pack.save_packed(packed6, prefix6)
    n6 = int((1 << 16) * V6_FRACTION)
    pool = (synth.render_syslog(packed6, synth.synth_tuples(packed6, (1 << 16) - n6, seed=21),
                                seed=21)
            + synth.render_syslog6(packed6, synth.synth_tuples6(packed6, n6, seed=22), seed=22))
    rng = np.random.default_rng(23)
    rng.shuffle(pool)
    idx = rng.choice(len(pool), size=FULL_B, p=synth.zipf_weights(len(pool), 1.0))
    logs6 = os.path.join(d, "fw1.log")
    with open(logs6, "w", encoding="utf-8") as f:
        f.write("\n".join(pool[i] for i in idx.tolist()) + "\n")
    mult = np.bincount(idx, minlength=len(pool))
    want6 = oracle_hits(rs6, ((parse_line(pool[i]), int(c)) for i, c in enumerate(mult) if c))
    rep6, n = cli_run(prefix6, logs6, "fused", batch, ("--feed-workers", "4", "--feed-mode", "ring"),
                      tag="-feed6")
    launches.update(n)
    check(n["first_match6"] > 0, "dual-stack ring run: the v6 kernel never launched")
    check(report_hits(rep6) == want6, "dual-stack ring run: counts != oracle")
    check([tuple(k) for k in rep6["unused"]] == oracle_unused(rs6, want6),
          "dual-stack ring run: unused != oracle")
    feed_line(f"dual-stack ring x4, {FULL_B} lines", rep6, card)

    # convert fleet: 4 weighted shards and a manifest, against one file
    # coalesced at the same 2^16-line granularity
    manifest = os.path.join(os.path.dirname(logs), "fleet.rawire")
    single = os.path.join(os.path.dirname(logs), "single-w.rawire")
    t0 = time.perf_counter()
    check(cli.main(["convert", "--ruleset", prefix, "--logs", logs, "--out", manifest,
                    "--workers", "4", "--block-rows", str(1 << 16)]) == 0,
          "convert --workers 4 failed")
    t_fleet = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(cli.main(["convert", "--ruleset", prefix, "--logs", logs, "--out", single,
                    "--native-parse", "--coalesce", "--block-rows", str(1 << 16)]) == 0,
          "convert --coalesce failed")
    t_single = time.perf_counter() - t0
    fleet_rep, n = cli_run(prefix, manifest, "scan", batch, tag="-fleet")
    launches.update(n)
    single_rep, n = cli_run(prefix, single, "scan", batch, tag="-single")
    launches.update(n)
    check(strip(fleet_rep) == strip(single_rep),
          "the manifest run's report differs from the single-file convert --coalesce run's")
    check(report_hits(fleet_rep) == want, "convert fleet run: counts != oracle")
    say(f"feeder: convert --workers 4 of {INGEST_TEXT_LINES} lines {t_fleet:.2f} s, "
        f"convert --coalesce (one process) {t_single:.2f} s (host clock, spawn included); "
        f"the manifest run == the single-file run")
    feed_line("convert fleet manifest, scan", fleet_rep, card)
    say(f"feeder: launches over the feeder runs {dict(launches)}")
    return dict(launches)


def phase_dual_stack(work: str, dev, card: str) -> dict:
    """The dual-stack path on the 16x256 ruleset with 30% IPv6 ACEs:
    synth --v6-fraction -> parse-acls -> run over text (native parse,
    prefetch 2) and over the converted wire-v2 file (plain, and weighted
    with scan).  Exact counts == oracle over 2^16 lines; the text and
    wire reports agree over 2^20 lines."""
    from collections import Counter

    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.hostside import aclparse, oracle, pack, synth

    d = os.path.join(work, "dual")
    n_small = 1 << 16
    check(cli.main(["synth", "--out-dir", d, "--acls", str(SHAPES[1][0]), "--rules",
                    str(SHAPES[1][1]), "--lines", str(n_small), "--seed", "0",
                    "--v6-fraction", str(V6_FRACTION)]) == 0, "cli synth --v6-fraction failed")
    prefix = os.path.join(d, "parsed")
    check(cli.main(["parse-acls", os.path.join(d, "fw1.cfg"), "--out", prefix]) == 0,
          "cli parse-acls failed")
    packed = pack.load_packed(prefix)
    check(packed.has_v6, "the dual-stack ruleset has no IPv6 rows")
    rs = aclparse.parse_config_file(os.path.join(d, "fw1.cfg"))
    launches = Counter()

    def runs_over(logs: str, batch: int, tag: str) -> dict:
        """Text run, then convert (plain, weighted) and the two wire runs."""
        out = {}
        plain, weighted = (os.path.join(d, f"fw1{tag}{s}.rawire") for s in ("", "-w"))
        for name, extra in (("plain", ()), ("weighted", ("--coalesce",))):
            path = plain if name == "plain" else weighted
            check(cli.main(["convert", "--ruleset", prefix, "--logs", logs, "--out", path,
                            "--native-parse", "--block-rows", str(batch), *extra]) == 0,
                  f"convert {name} failed")
            with open(path, "rb") as fh:
                magic = fh.read(8)
            check(magic == (b"RAWIREv3" if extra else b"RAWIREv2"), f"{name} file is {magic!r}")
        for name, path, impl, extra in (
            ("text native, prefetch 2", logs, "fused", ("--native-parse", "--prefetch-depth", "2")),
            ("wire v2 plain", plain, "fused", ()),
            ("wire v2 weighted, scan", weighted, "scan", ()),
        ):
            rep, n = cli_run(prefix, path, impl, batch, extra, tag=f"{tag}-{len(out)}")
            check(n["first_match6"] > 0, f"{name}: the v6 kernel never launched")
            launches.update(n)
            out[name] = rep
            hits = sum(e["hits"] for e in rep["per_rule"])
            check(hits == rep["totals"]["lines_matched"], f"{name}: counts total != lines_matched")
            ingest_line(f"dual-stack {tag} {name}", rep, card,
                        f", launches {n}, wire_rows {rep['totals'].get('wire_rows')}")
        text = strip(out["text native, prefetch 2"])
        for name in ("wire v2 plain", "wire v2 weighted, scan"):
            w = strip(out[name])
            check(w["per_rule"] == text["per_rule"] and w["unused"] == text["unused"],
                  f"{name} report differs from the text run")
        return out

    out = runs_over(os.path.join(d, "fw1.log"), 1 << 14, "2^16")
    with open(os.path.join(d, "fw1.log"), encoding="utf-8") as fh:
        res = oracle.Oracle([rs]).consume(fh)
    for name, rep in out.items():
        check(report_hits(rep) == dict(res.hits), f"dual-stack {name}: counts != oracle")
        check([tuple(k) for k in rep["unused"]] == res.unused_rules([rs]),
              f"dual-stack {name}: unused != oracle")
        check(rep["totals"]["lines_matched"] == res.lines_matched, f"{name}: lines_matched")
    say(f"dual-stack: {n_small} lines ({packed.rules.shape[0]} v4 + {packed.rules6.shape[0]} "
        f"v6 rows, {packed.n_keys} keys): text, wire v2 and weighted wire exact counts and "
        f"{len(out['wire v2 plain']['unused'])} unused rules == oracle")

    big = os.path.join(d, "big.log")
    t0 = time.perf_counter()
    synth.synth_syslog_file(packed, big, FULL_B, seed=7, v6_fraction=V6_FRACTION)
    say(f"dual-stack: synthesised {FULL_B} lines in {time.perf_counter() - t0:.1f} s")
    big_runs = runs_over(big, 1 << 18, "2^20")
    say(f"dual-stack: {FULL_B} lines: text, wire v2 and weighted wire reports agree "
        "(per-rule hits, unique sources, unused)")

    # v6 chunks cross to the card by a pageable copy of the host array
    arr = np.random.default_rng(0).integers(0, 1 << 32, size=(13, 1 << 18), dtype=np.uint32)
    host = torch.from_numpy(arr.view(np.int32))
    host.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        host.to(dev)
    torch.cuda.synchronize()
    say(f"dual-stack: H2D of a 2^18-line v6 tuple chunk (13.6 MB), pageable .to(cuda): "
        f"{arr.nbytes * 20 / 1e9 / (time.perf_counter() - t0):.2f} GB/s (host clock) on {card}")
    say(f"dual-stack: launches over its runs {dict(launches)}")
    return dict(launches), {"prefix": prefix, "small": os.path.join(d, "fw1.log"), "rs": rs,
                            "small_res": res, "big": big,
                            "big_wire": os.path.join(d, "fw12^20.rawire"),
                            "small_wire": os.path.join(d, "fw12^16.rawire"),
                            "big_text": big_runs["text native, prefetch 2"]}


def phase_resume(work: str, dev, card: str) -> dict:
    """Checkpoint/resume at full width: a run killed by ``max_chunks`` and
    continued with ``run --resume`` gives the report of the run that was
    never stopped, and its remaining chunks launch the kernels.

    (a) 16x256 v4 text, native parse, prefetch 2: 2^20 Zipf-flow lines at
    batch 2^16 (16 chunks) with ``--checkpoint-every 4``, killed after 10
    batches (the snapshot holds 8); exact counts == oracle.  (b) the
    dual-stack phase's 2^20-line wire v2 and weighted v3 files at B = 2^18,
    killed in the v6 phase (and the v3 file in its v4 phase too).  Prints
    the snapshot's bytes, its save and load seconds, and the text run's
    sustained rate with and without checkpoints."""
    import statistics
    from collections import Counter

    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire
    from ruleset_analysis_tpu_torch.hostside.syslog import parse_line
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file, run_stream_wire

    d = os.path.join(work, "resume")
    os.makedirs(d, exist_ok=True)
    text, packed = ruleset(*SHAPES[1])
    rs = aclparse.parse_asa_config(text, "fw1")
    prefix = os.path.join(d, "fw1")
    pack.save_packed(packed, prefix)
    launches = Counter()

    n, b = RESUME_LINES, RESUME_B
    logs = os.path.join(d, "fw1.log")
    pool, idx = synth.flow_draws(packed, n, 1 << 16, skew=1.0, seed=13)
    line_counts = Counter()
    t0 = time.perf_counter()
    with open(logs, "w", encoding="utf-8") as f:
        for i in range(0, n, 1 << 18):
            lines = synth.render_syslog(packed, pool[idx[i:i + (1 << 18)]], seed=13 + i)
            line_counts.update(lines)
            f.write("\n".join(lines) + "\n")
    want = oracle_hits(rs, ((parse_line(ln), c) for ln, c in line_counts.items()))
    say(f"resume: {n} text lines ({len(line_counts)} distinct) and their oracle in "
        f"{time.perf_counter() - t0:.1f} s")
    text_flags = ("--native-parse", "--prefetch-depth", "2")

    # uninterrupted, in turns: no checkpoints, every 4, every 4, none, ...
    runs = []
    rates = {0: [], 4: []}
    for k, every in enumerate((0, 4, 4, 0, 0, 4)):
        extra = text_flags + (("--checkpoint-every", str(every), "--checkpoint-dir",
                               os.path.join(d, f"ck-full{k}")) if every else ())
        rep, got = cli_run(prefix, logs, "fused", b, extra, tag=f"-full{k}")
        launches.update(got)
        runs.append(rep)
        t = rep["totals"]
        rates[every].append(t["sustained_lines_per_sec"])
        say(f"resume: uninterrupted 16x256 text run, {n} lines, batch {b}, native, prefetch "
            f"2, {'--checkpoint-every 4' if every else 'no checkpoints'}: "
            f"sustained_lines_per_sec {t['sustained_lines_per_sec']}, elapsed_sec "
            f"{t['elapsed_sec']}, chunks {t['chunks']}; on {card}")
    say(f"resume: sustained_lines_per_sec of the uninterrupted text run, median of 3 in "
        f"turns: no checkpoints {statistics.median(rates[0])}, --checkpoint-every 4 "
        f"{statistics.median(rates[4])}; on {card}")
    full = runs[1]
    check(full["totals"]["chunks"] == n // b, f"{full['totals']['chunks']} chunks, not {n // b}")
    check(report_hits(full) == want, "resume: exact counts differ from the oracle")
    for rep in runs:
        check(strip(rep) == strip(full), "checkpoints changed the text run's report")

    ck = os.path.join(d, "ck")
    cfg = AnalysisConfig(batch_size=b, checkpoint_every_chunks=4, checkpoint_dir=ck,
                         prefetch_depth=2, match_impl="fused")
    run_stream_file(packed, [logs], cfg, native=True, max_chunks=10)
    snap = ckpt.load(ck)
    check(snap is not None and (snap.n_chunks, snap.lines_consumed) == (8, 8 * b),
          f"the killed run's snapshot: {None if snap is None else snap.n_chunks} chunks")
    rep, got = cli_run(prefix, logs, "fused", b, text_flags + (
        "--checkpoint-every", "4", "--checkpoint-dir", ck, "--resume"), tag="-resumed",
        chunks_before=8)
    launches.update(got)
    check(got["match_hist"] == n // b - 8, f"the resumed run launched match_hist {got} times")
    check(strip(rep) == strip(full), "the resumed text report differs from the uninterrupted")
    check(report_hits(rep) == want, "the resumed text run's exact counts differ from the oracle")
    say(f"resume: 16x256 text run killed after 10 batches (snapshot at chunk 8), resumed "
        f"with run --resume: report == uninterrupted, exact counts == oracle; launches "
        f"{got}")

    # the snapshot: its bytes, load + state_of on the card, save (D2H included)
    live = os.path.join(ck, open(os.path.join(ck, ckpt.POINTER_FILE)).read().strip())
    sizes = {f: os.path.getsize(os.path.join(live, f))
             for f in (ckpt.STATE_FILE, ckpt.MANIFEST_FILE)}
    loads, saves = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = ckpt.load(ck)
        state = ckpt.state_of(s, dev)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        tracker = ckpt.restore_tracker(s, 256)
        t0 = time.perf_counter()
        ckpt.save(os.path.join(d, "ck-timing"), ckpt.snapshot_of(
            state, lines_consumed=s.lines_consumed, n_chunks=s.n_chunks + i, parsed=s.parsed,
            skipped=s.skipped, tracker=tracker, fingerprint=s.fingerprint, extra=s.extra))
        saves.append(time.perf_counter() - t0)
        got_arrays = pipeline.state_to_numpy(state)
        check(all(np.array_equal(got_arrays[k], v) for k, v in s.arrays.items()),
              "registers changed on their way through the card")
    say(f"resume: snapshot of the 16x256 run ({packed.n_keys} keys): state.npz "
        f"{sizes[ckpt.STATE_FILE]} bytes, manifest.json {sizes[ckpt.MANIFEST_FILE]} bytes; "
        f"save (registers to the host, npz, fsync, pointer commit) median "
        f"{statistics.median(saves):.4f} s (min {min(saves):.4f}, max {max(saves):.4f}); "
        f"load + state_of onto the card median {statistics.median(loads):.4f} s (min "
        f"{min(loads):.4f}, max {max(loads):.4f}), 5 each, host clock; on {card}")

    # (b) the dual-stack phase's wire files, killed in the v6 phase
    dd = os.path.join(work, "dual")
    dprefix = os.path.join(dd, "parsed")
    dpacked = pack.load_packed(dprefix)
    b6 = RESUME_B6
    for name, fname, impl, phase in (("wire v2", "fw12^20.rawire", "fused", 6),
                                     ("weighted wire v3", "fw12^20-w.rawire", "scan", 6),
                                     ("weighted wire v3", "fw12^20-w.rawire", "scan", 4)):
        path = os.path.join(dd, fname)
        r = wire.WireReader([path], dpacked)
        n4_rows, n4, n6 = r.n_rows, -(-r.n_rows // b6), -(-r.n6_rows // b6)
        r.close()
        check(n4 >= 2 and n6 >= 2, f"{name}: {n4} v4 and {n6} v6 chunks, too few to kill")
        crash = n4 + 1 if phase == 6 else n4 - 1
        full, got = cli_run(dprefix, path, impl, b6, tag=f"-full-{impl}-{phase}")
        launches.update(got)
        ck = os.path.join(d, f"ck-{impl}-{phase}")
        run_stream_wire(dpacked, [path], AnalysisConfig(
            batch_size=b6, checkpoint_every_chunks=1, checkpoint_dir=ck, match_impl=impl),
            max_chunks=crash)
        snap = ckpt.load(ck)
        check(snap.n_chunks == crash and (snap.lines_consumed > n4_rows) == (phase == 6),
              f"{name}: the snapshot is at chunk {snap.n_chunks}, row {snap.lines_consumed}")
        rep, got = cli_run(dprefix, path, impl, b6, ("--checkpoint-every", "1",
                                                      "--checkpoint-dir", ck, "--resume"),
                           tag=f"-resumed-{impl}-{phase}", chunks_before=crash)
        launches.update(got)
        kern = "match_hist" if impl == "fused" else "first_match"
        check(got["first_match6"] == (n6 - 1 if phase == 6 else n6)
              and got[kern] == (0 if phase == 6 else 1),
              f"{name}: the resumed run launched {got}")
        check(strip(rep) == strip(full), f"{name}: the resumed report differs")
        say(f"resume: dual-stack {name} ({n4} v4 + {n6} v6 chunks at B = {b6}) killed in "
            f"its v{phase} phase after {crash} chunks, resumed with run --resume: report == "
            f"uninterrupted; launches {got}")
    return dict(launches)


def stacked_line(what: str, rep: dict, card: str, grouped: int, slots: int, valid: int) -> None:
    """One run of the stacked phase: its rate, grouped chunks and fill share."""
    t = rep["totals"]
    ing = t.get("ingest") or {}
    fill = f"{valid / (grouped * slots):.4f}" if grouped else "n/a (no grouped chunk)"
    say(f"stacked {what}: sustained_lines_per_sec {t['sustained_lines_per_sec']}, "
        f"lines_per_sec {t['lines_per_sec']}, chunks {t['chunks']} ({grouped} grouped of "
        f"{slots} slots), fill share {fill} ({valid} valid lines), elapsed_sec "
        f"{t['elapsed_sec']}, totals.ingest starved_sec {ing.get('starved_sec')} "
        f"produce_sec {ing.get('produce_sec')}; on {card}")


def v4_rows_of(path: str, packed) -> int:
    """The v4 evaluation rows of a converted corpus: its valid v4 lines."""
    from ruleset_analysis_tpu_torch.hostside import wire

    r = wire.WireReader([path], packed)
    try:
        return r.n_rows
    finally:
        r.close()


def registers_of(ck: str) -> dict:
    """The registers of a run's final snapshot."""
    from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt

    snap = ckpt.load(ck)
    check(snap is not None, f"no snapshot in {ck}")
    return snap.arrays


def phase_stacked(work: str, dev, card: str, ing: dict, dual: dict) -> dict:
    """`run --layout stacked --match-impl scan` through the CLI at 16 ACLs:
    the ingest phase's 2^21-line text corpus and its plain wire file, flat
    and stacked (text twice each, in turns); four firewalls' rulesets
    packed together over 2^20 lines; the dual-stack phase's corpora; a
    stacked text run killed and resumed.  Registers equal the flat scan
    run's, counts and unused the oracle's; each stacked run prints its
    rate, grouped chunks and fill share (valid lines over G x lane slots,
    summed over the grouped chunks), and the host time of grouping one
    batch alone."""
    import statistics
    from collections import Counter

    import numpy as np

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import aclparse, fastparse, pack, synth
    from ruleset_analysis_tpu_torch.hostside.syslog import parse_line
    from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    d = os.path.join(work, "stacked")
    os.makedirs(d, exist_ok=True)
    batch = STACKED_B
    launches = Counter()
    rs, prefix, logs, want = ing["rs"], ing["prefix"], ing["logs"], ing["want"]
    unused = oracle_unused(rs, want)
    n_acls = pack.load_packed(prefix).n_acls
    lane = batch // n_acls
    slots = n_acls * lane
    stacked = ("--layout", "stacked")

    def final(tag):
        return ("--checkpoint-every", str(1 << 20), "--checkpoint-dir", os.path.join(d, tag))

    # (a) 16x256 text, flat scan and stacked in turns; registers of each
    regs, reps = {}, {}
    for i, lay in enumerate(("flat", "stacked", "stacked", "flat")):
        tag = f"text-{lay}-{i}"
        extra = ("--native-parse", "--prefetch-depth", "2") + final(tag) + (
            stacked if lay == "stacked" else ())
        rep, n = cli_run(prefix, logs, "scan", batch, extra, tag=f"-{tag}")
        launches.update(n)
        check(report_hits(rep) == want, f"stacked phase, {tag}: counts != oracle")
        check([tuple(k) for k in rep["unused"]] == unused, f"{tag}: unused != oracle")
        regs[tag], reps[tag] = registers_of(os.path.join(d, tag)), rep
        if lay == "stacked":
            stacked_line(f"16x256 text, {INGEST_TEXT_LINES} lines, batch {batch}, lane {lane}, "
                         f"run {i}", rep, card, n["first_match"], slots,
                         rep["totals"]["lines_matched"])
        else:
            ingest_line(f"16x256 text flat scan (stacked phase, run {i})", rep, card)
    for tag, r in regs.items():
        for k in ("counts_lo", "counts_hi", "cms", "hll", "talk_cms"):
            check(np.array_equal(r[k], regs["text-flat-0"][k]),
                  f"stacked phase: {tag} register {k} != the flat scan run's")
    check(strip(reps["text-stacked-1"]) == strip(reps["text-stacked-2"]),
          "the two stacked text runs differ")

    # the host time of grouping one native-parsed 2^18-line batch alone:
    # GroupBuffer.add (stable argsort, gather, per-ACL slices) + flush,
    # then flatten_grouped + compact_batch of every grouped batch
    b0, _ = next(iter(fastparse.batches_from_files([logs], fastparse.NativePacker(
        pack.load_packed(prefix)), batch)))
    b0 = np.array(b0)
    times, flat_times = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        gbuf = pack.GroupBuffer(n_acls, lane)
        out = gbuf.add(np.ascontiguousarray(b0.T)) + gbuf.flush()
        for g in out:
            pack.compact_batch(pack.flatten_grouped(g))
        t1 = time.perf_counter()
        pack.compact_batch(b0)
        times.append(t1 - t0)
        flat_times.append(time.perf_counter() - t1)
    say(f"stacked: grouping one {batch}-line text batch on the host (transpose, "
        f"GroupBuffer.add + flush into {len(out)} grouped batches, flatten + compact_batch): "
        f"median {statistics.median(times) * 1e3:.2f} ms (min {min(times) * 1e3:.2f}) of 7, "
        f"host clock; compact_batch of the flat batch alone median "
        f"{statistics.median(flat_times) * 1e3:.2f} ms; on {card}")

    # first_match over the same 2^20 lines in source order and group-major
    # order (a stable sort by ACL, what a single-emission grouped batch
    # holds): each warp's 32 lines then share one ACL span
    import torch

    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops import first_match

    packed16 = pack.load_packed(prefix)
    r = pipeline.ship_ruleset(packed16, dev)
    tuples = synth.synth_tuples(packed16, FULL_B, seed=1)
    order = np.argsort(tuples[:, 0], kind="stable")
    f_src, f_grp = (line_fields(t, dev)[:6] for t in (tuples, tuples[order]))
    rows_src = first_match.first_match_rows(f_src, r.rules_k, r.acl_span)
    rows_grp = first_match.first_match_rows(f_grp, r.rules_k, r.acl_span)
    check(torch.equal(rows_grp, rows_src[torch.from_numpy(order).to(rows_src.device)]),
          "first_match over group-major lines != its source-order rows, permuted")
    rounds = {"source": [], "group-major": []}
    for _ in range(3):
        for k, f in (("source", f_src), ("group-major", f_grp)):
            rounds[k].append(cuda_ms(lambda: first_match.first_match_rows(f, r.rules_k,
                                                                          r.acl_span), 20))
    say(f"stacked: first_match at B={FULL_B}, Rp={r.rules_k.shape[0]}, lines in source order "
        f"{sorted(rounds['source'])[1]:.4f} ms, group-major "
        f"{sorted(rounds['group-major'])[1]:.4f} ms (medians of 3 rounds of 20, in turns, "
        f"CUDA events); {gpu_clocks()} (SM clock, power draw, temperature); on {card}")

    # (b) the plain wire file of the same corpus: expand, group, re-pack
    # (and with a lane of 2^13: grouped chunks half a batch wide through
    # the pinned ring)
    plain = os.path.join(os.path.dirname(logs), "fw1.rawire")
    for lay, lane_ in (("flat", 0), ("stacked", 0), ("stacked", lane // 2)):
        extra = (stacked + (("--stacked-lane", str(lane_)) if lane_ else ())
                 if lay == "stacked" else ())
        rep, n = cli_run(prefix, plain, "scan", batch, extra,
                         tag=f"-stacked-wire-{lay}-{lane_}")
        launches.update(n)
        check(report_hits(rep) == want, f"stacked phase, wire {lay} {lane_}: counts != oracle")
        if lay == "stacked":
            check(strip(rep)["per_rule"] == strip(reps["text-stacked-1"])["per_rule"],
                  "stacked wire per-rule report != the stacked text run's")
            stacked_line(f"16x256 plain wire, {INGEST_TEXT_LINES} rows, batch {batch}, lane "
                         f"{lane_ or lane}", rep, card, n["first_match"],
                         n_acls * (lane_ or lane), rep["totals"]["lines_matched"])
        else:
            ingest_line("16x256 plain wire flat scan (stacked phase)", rep, card)

    # (c) four firewalls' rulesets packed together (16 ACLs of 256 rules),
    # 2^20 lines: Zipf(1.0) draws over 2^15 synth_tuples flows, rendered
    rulesets = [aclparse.parse_asa_config(
        synth.synth_config(n_acls=4, rules_per_acl=256, seed=s), f"fw{s}") for s in range(4)]
    mpacked = pack.pack_rulesets(rulesets)
    mprefix = os.path.join(d, "multi")
    pack.save_packed(mpacked, mprefix)
    mlogs = os.path.join(d, "multi.log")
    pool, idx = synth.flow_draws(mpacked, FULL_B, 1 << 15, skew=1.0, seed=31)
    line_counts = Counter()
    t0 = time.perf_counter()
    with open(mlogs, "w", encoding="utf-8") as f:
        for i in range(0, FULL_B, batch):
            lines = synth.render_syslog(mpacked, pool[idx[i:i + batch]], seed=31 + i)
            line_counts.update(lines)
            f.write("\n".join(lines) + "\n")
    mwant = oracle_hits(rulesets, ((parse_line(ln), c) for ln, c in line_counts.items()))
    say(f"stacked: 4 firewalls x 4 ACLs x 256 rules ({mpacked.rules.shape[0]} rows, "
        f"{mpacked.n_acls} ACLs), {FULL_B} lines ({len(line_counts)} distinct) and their "
        f"oracle in {time.perf_counter() - t0:.1f} s")
    for lay in ("flat", "stacked"):
        rep, n = cli_run(mprefix, mlogs, "scan", batch, stacked if lay == "stacked" else (),
                         tag=f"-multi-{lay}")
        launches.update(n)
        check(report_hits(rep) == mwant, f"multi-firewall {lay}: counts != oracle")
        check([tuple(k) for k in rep["unused"]] == oracle_unused(rulesets, mwant),
              f"multi-firewall {lay}: unused != oracle")
        if lay == "stacked":
            stacked_line(f"multi-firewall, {FULL_B} lines, batch {batch}", rep, card,
                         n["first_match"], mpacked.n_acls * (batch // mpacked.n_acls),
                         rep["totals"]["lines_matched"])
        else:
            ingest_line("multi-firewall flat scan (stacked phase)", rep, card)

    # (d) dual-stack 16x256: the 2^16-line corpus against the oracle, the
    # 2^20-line one against the dual-stack phase's flat text run
    dprefix, dpacked = dual["prefix"], pack.load_packed(dual["prefix"])
    dslots = dpacked.n_acls * (batch // dpacked.n_acls)
    rep, n = cli_run(dprefix, dual["small"], "scan", 1 << 14, stacked, tag="-stacked6")
    launches.update(n)
    res = dual["small_res"]
    check(n["first_match6"] > 0, "dual-stack stacked run: the v6 kernel never launched")
    check(report_hits(rep) == dict(res.hits), "dual-stack stacked 2^16: counts != oracle")
    check([tuple(k) for k in rep["unused"]] == res.unused_rules([dual["rs"]]),
          "dual-stack stacked 2^16: unused != oracle")
    stacked_line(f"dual-stack 16x256 text, {1 << 16} lines, batch {1 << 14} (v4 lanes; "
                 f"{n['first_match6']} v6 chunks)", rep, card, n["first_match"],
                 dpacked.n_acls * ((1 << 14) // dpacked.n_acls),
                 v4_rows_of(dual["small_wire"], dpacked))
    rep, n = cli_run(dprefix, dual["big"], "scan", batch, stacked, tag="-stacked6-big")
    launches.update(n)
    flat6 = strip(dual["big_text"])
    check(strip(rep)["per_rule"] == flat6["per_rule"] and strip(rep)["unused"] == flat6["unused"],
          "dual-stack stacked 2^20: report != the flat text run's")
    stacked_line(f"dual-stack 16x256 text, {FULL_B} lines, batch {batch} (v4 lanes; "
                 f"{n['first_match6']} v6 chunks)", rep, card, n["first_match"], dslots,
                 v4_rows_of(dual["big_wire"], dpacked))

    # (e) stacked text killed after 3 source batches and resumed
    flags = ("--native-parse", "--prefetch-depth", "2") + stacked
    ck_full = os.path.join(d, "ck-full")
    full, n = cli_run(prefix, logs, "scan", batch, flags + (
        "--checkpoint-every", "2", "--checkpoint-dir", ck_full), tag="-resume-full")
    launches.update(n)
    ck = os.path.join(d, "ck")
    cfg = AnalysisConfig(batch_size=batch, checkpoint_every_chunks=2, checkpoint_dir=ck,
                         prefetch_depth=2, layout="stacked", match_impl="scan")
    run_stream_file(pack.load_packed(prefix), [logs], cfg, native=True, max_chunks=3)
    snap = ckpt.load(ck)
    check(snap is not None and 0 < snap.n_chunks < full["totals"]["chunks"],
          "the killed stacked run left no snapshot")
    rep, n = cli_run(prefix, logs, "scan", batch, flags + (
        "--checkpoint-every", "2", "--checkpoint-dir", ck, "--resume"), tag="-resumed",
        chunks_before=snap.n_chunks)
    launches.update(n)
    check(strip(rep) == strip(full),
          "the resumed stacked report differs from the uninterrupted checkpointed run's")
    check(report_hits(rep) == want, "the resumed stacked run's counts differ from the oracle")
    say(f"stacked: text run killed after 3 source batches (snapshot at grouped chunk "
        f"{snap.n_chunks}, {snap.lines_consumed} lines), resumed with run --resume: report == "
        f"the uninterrupted --checkpoint-every 2 run's ({full['totals']['chunks']} chunks)")
    say(f"stacked: launches over its runs {dict(launches)}")
    return dict(launches)


def phase_device_step(dev, card: str) -> None:
    """The step alone at B = 2^20 wire-layout lines resident on the card."""
    import numpy as np
    import torch

    import functools

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.runtime.timing import timed_validated_steps

    cfg = AnalysisConfig(batch_size=FULL_B)
    steps = 8
    for n_acls, per in SHAPES:
        _, packed = ruleset(n_acls, per)
        tuples = synth.synth_tuples(packed, FULL_B, seed=3)
        wire = torch.from_numpy(
            pack.compact_batch(np.ascontiguousarray(tuples.T)).view(np.int32)).to(dev)
        rules = pipeline.ship_ruleset(packed, dev)
        shape = f"{n_acls}x{per} ruleset (Rp={rules.rules_k.shape[0]})"
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
            check(total == (steps + 1) * FULL_B,
                  f"device step counted {total} != {(steps + 1) * FULL_B}")
            say(f"device step ({impl}): B={FULL_B} wire lines, {shape}: {dt * 1e3:.3f} ms/step, "
                f"{FULL_B / dt:.0f} lines/s on {card}; counts delta == valid lines stepped")
            state, win, delta, expect = timed_validated_steps(
                functools.partial(pipeline.analysis_step, n_keys=packed.n_keys,
                                  topk_k=cfg.sketch.topk_chunk_candidates, match_impl=impl),
                state, rules, [wire], [FULL_B], steps)
            check(delta == expect, f"counts-closed window: delta {delta} != {expect}")
            say(f"device step ({impl}), {shape}: counts-closed window (runtime/timing.py) "
                f"{win / steps * 1e3:.3f} ms/step over {steps} steps, count delta {delta} == "
                f"lines stepped")
            kernel = "match_hist_kernel" if impl == "fused" else "first_match_kernel"
            breakdown(step, steps, dt * 1e3, f"{impl}, {shape}", kernel)

    # the v6 step on the dual-stack ruleset, beside its v4 step, at B = 2^20
    # lines of each family resident on the card (v6 in the tuple layout
    # its text chunks take, and in the wire layout)
    _, packed = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
    rules, rules6 = pipeline.ship_ruleset(packed, dev), pipeline.ship_ruleset6(packed, dev)
    t4 = np.ascontiguousarray(synth.synth_tuples(packed, FULL_B, seed=3).T)
    t6 = np.ascontiguousarray(synth.synth_tuples6(packed, FULL_B, seed=3).T)
    batches = {
        "v4 (fused, wire layout)": (pack.compact_batch(t4), "match_hist_kernel"),
        "v6 (tuple layout)": (t6, "first_match6_kernel"),
        "v6 (wire layout)": (pack.compact_batch6(t6), "first_match6_kernel"),
    }
    shape = (f"dual-stack {SHAPES[1][0]}x{SHAPES[1][1]} ruleset (Rp={rules.rules_k.shape[0]}, "
             f"R6p={rules6.rules_k6.shape[0]})")
    for what, (arr, kernel) in batches.items():
        batch = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(dev)
        state = pipeline.init_state(packed.n_keys, cfg, dev)
        v6 = what.startswith("v6")

        def step(salt):
            if v6:
                return pipeline.analysis_step6(
                    state, rules6, batch, n_keys=packed.n_keys,
                    topk_k=cfg.sketch.topk_chunk_candidates, salt=salt)[0]
            return pipeline.analysis_step(
                state, rules, batch, n_keys=packed.n_keys,
                topk_k=cfg.sketch.topk_chunk_candidates, salt=salt, match_impl="fused")[0]

        state = step(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, steps + 1):
            state = step(s)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        total = pipeline.counts_total(state)
        check(total == (steps + 1) * FULL_B, f"{what} step counted {total}")
        say(f"device step {what}: B={FULL_B}, {shape}: {dt * 1e3:.3f} ms/step, "
            f"{FULL_B / dt:.0f} lines/s on {card}")
        breakdown(step, steps, dt * 1e3, f"{what}, {shape}", kernel)


def tail_inputs(dev, v6: bool = False, flows: int = 0):
    """The register tail's inputs of one default step at B = 2^20 on the
    16x256 ruleset (the dual-stack one for v6): the match kernel's rows,
    the batch's int32 weight plane, acl and source columns (v6: the four
    limbs), the key table and the gid tag.  ``flows``: v4 lines drawn from
    that many flows, Zipf(1.2)."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops import first_match, first_match6

    if v6:
        _, packed = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
        r6 = pipeline.ship_ruleset6(packed, dev)
        t6 = np.ascontiguousarray(synth.synth_tuples6(packed, FULL_B, seed=4).T)
        batch = torch.from_numpy(pack.compact_batch6(t6).view(np.int32)).to(dev)
        cols, valid = pipeline.batch_cols6(batch)
        row = first_match6.first_match_rows6([cols[k] for k in first_match6.FIELDS6],
                                             r6.rules_k6, r6.acl_span6)
        lines = dict(src=tuple(cols[f"src{i}"] for i in range(4)), key_k=r6.key_k6,
                     n_rows=r6.rules_k6.shape[0], acl_tag=pipeline.V6_ACL_TAG)
    else:
        _, packed = ruleset(*SHAPES[1])
        r = pipeline.ship_ruleset(packed, dev)
        t = (synth.synth_flow_tuples(packed, FULL_B, flows, skew=1.2, seed=3) if flows
             else synth.synth_tuples(packed, FULL_B, seed=3))
        t = np.ascontiguousarray(t.T)
        batch = torch.from_numpy(pack.compact_batch(t).view(np.int32)).to(dev)
        cols, valid = pipeline.batch_cols(batch)
        row = first_match.first_match_rows([cols[k] for k in first_match.FIELDS], r.rules_k,
                                           r.acl_span)
        lines = dict(src=(cols["src"],), key_k=r.key_k, n_rows=r.rules_k.shape[0], acl_tag=0)
    return packed.n_keys, dict(row=row, valid=valid, acl=cols["acl"], **lines)


def tail_call(fn, talk, hll, lines: dict, valid, **opts):
    """reg_tail (or its plain version) of ``lines`` with weights ``valid``."""
    return fn(talk, hll, lines["row"], valid, lines["acl"], lines["src"], lines["key_k"],
              n_rows=lines["n_rows"], acl_tag=lines["acl_tag"], **opts)


def phase_reg_tail(dev, card: str) -> dict:
    """reg_tail and the select against their plain versions (tolerance 0) at
    the main path's shapes and at edge shapes, the counts delta in the block
    histograms and with global atomics; times and bounds at B = 2^20."""
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import synth
    from ruleset_analysis_tpu_torch.ops import reg_tail, topk

    sk = AnalysisConfig().sketch
    gen = torch.Generator(device="cpu").manual_seed(0)

    def registers(n_keys):
        """A live-looking register file: talker counts and HLL ranks."""
        talk = torch.randint(0, 1 << 20, (sk.talk_cms_depth, sk.cms_width), generator=gen)
        hll = torch.randint(0, 12, (n_keys, sk.hll_m), generator=gen)
        return talk.to(dev), hll.to(dev)

    def run(talk, hll, lines, weights, opts, plain, force_global=False):
        talk, hll = talk.clone(), hll.clone()
        k = topk.cand_k(sk.topk_chunk_candidates, weights.shape[0], opts["sample_shift"])
        if plain:
            delta, cnt, rep = tail_call(reg_tail.reg_tail_plain, talk, hll, lines, weights,
                                        **opts)
        else:
            delta, cnt, rep = tail_call(reg_tail.reg_tail, talk, hll, lines, weights,
                                        force_global=force_global, **opts)
        out = [talk, hll, delta, cnt, rep]
        if opts["select"]:
            pick = reg_tail.select_tables_plain if plain else reg_tail.select_tables
            out += pick(cnt, rep, lines["acl"], lines["src"], talk, k, acl_tag=lines["acl_tag"],
                        salt=opts["salt"], sample_shift=opts["sample_shift"])
        torch.cuda.synchronize()
        return out

    err = {"reg_tail": 0, "select": 0}

    def same(a, b):
        """Both outputs alike (None where the other is None); record the
        largest difference of the tail's and the select's outputs."""
        if len(a) != len(b) or any((x is None) != (y is None) for x, y in zip(a, b)):
            return False
        for name, part in (("reg_tail", slice(0, 5)), ("select", slice(5, None))):
            pairs = [(x, y) for x, y in zip(a[part], b[part]) if x is not None]
            e = max_abs_err([x for x, _ in pairs], [y for _, y in pairs]) if pairs else 0
            err[name] = max(err[name], e)
            if e:
                return False
        return True

    def both_modes(talk, hll, lines, weights, opts, what):
        """The kernel in each counts mode against the plain version."""
        want = run(talk, hll, lines, weights, opts, True)
        for glob in ((False, True) if opts["counts"] else (False,)):
            check(same(run(talk, hll, lines, weights, opts, False, glob), want),
                  f"reg_tail != plain on {what}" + (" (global counts)" if glob else ""))

    n_keys, lines = tail_inputs(dev)
    talk0, hll0 = registers(n_keys)
    w = lines["valid"]
    wts = torch.randint(-(1 << 31), 1 << 31, (FULL_B,), dtype=torch.int32, generator=gen).to(dev)
    main = {
        "fused route (delta given)": (w, dict(counts=False)),
        "scan route (delta in the kernel)": (w, dict(counts=True)),
        "sample_shift 3": (w, dict(counts=True, sample_shift=3, salt=11)),
        "deferred chunk": (w, dict(counts=True, select=False)),
        "weighted rows": (wts, dict(counts=True, sample_shift=3, salt=6)),
    }
    for name, (weights, kw) in main.items():
        both_modes(talk0, hll0, lines, weights, dict(dict(select=True, sample_shift=0, salt=5),
                                                     **kw), name)
    n6, lines6 = tail_inputs(dev, v6=True)
    t6, h6 = registers(n6)
    opts6 = dict(counts=True, select=True, sample_shift=0, salt=3)
    both_modes(t6, h6, lines6, lines6["valid"], opts6, "v6")
    _, skew = tail_inputs(dev, flows=1 << 10)
    opts_skew = dict(counts=True, select=True, sample_shift=0, salt=5)
    both_modes(talk0, hll0, skew, skew["valid"], opts_skew, "Zipf(1.2) skew")
    # one talker on every line: every warp is one pair group
    one = dict(lines, acl=torch.zeros_like(lines["acl"]),
               src=(torch.full_like(lines["src"][0], 0x0A000001),))
    both_modes(talk0, hll0, one, w, opts_skew, "one talker")
    say(f"kernels: B={FULL_B}, {n_keys} keys (16x256), talker CMS {sk.talk_cms_depth}x"
        f"{sk.cms_width}, HLL {n_keys}x{sk.hll_m}: reg_tail (shared and global counts) and "
        f"the select bit-identical to plain (tolerance 0) on {', '.join(main)}, the v6 step's "
        "inputs, Zipf(1.2) skew and one talker")
    for name, case in synth.reg_tail_cases(100003, n_keys, seed=4).items():
        case_lines = {k: torch.from_numpy(case[k]).to(dev) for k in ("row", "acl", "key_k")}
        case_lines.update(src=tuple(torch.from_numpy(x).to(dev) for x in case["src"]),
                          n_rows=case["n_rows"], acl_tag=case["acl_tag"])
        weights = torch.from_numpy(case["valid"]).to(dev)
        opts = {k: case[k] for k in ("counts", "select", "sample_shift", "salt")}
        both_modes(talk0, hll0, case_lines, weights, opts, f"edge shape {name}")
        say(f"kernels: reg_tail edge shape {name} (B={weights.shape[0]}): bit-identical to plain")
    slots = topk.CAND_SLOTS
    for name, case in synth.select_cases(slots, FULL_B, seed=6).items():
        cnt, rep = (torch.from_numpy(case[k]).to(dev) for k in ("cnt", "rep"))
        for k in (1, 63, 64, reg_tail.select_rank_cap() + 1, slots):
            got = reg_tail.select_tables(cnt, rep, lines["acl"], lines["src"], talk0, k)
            want = reg_tail.select_tables_plain(cnt, rep, lines["acl"], lines["src"], talk0, k)
            torch.cuda.synchronize()
            e = max_abs_err(list(got), list(want))
            err["select"] = max(err["select"], e)
            check(e == 0, f"select != plain on table {name}, k={k}")
    say(f"kernels: select bit-identical to plain on every synth.select_cases table at k = 1, "
        f"63, 64, {reg_tail.select_rank_cap() + 1} (two launches) and {slots}")

    def bound(lines, ms, plain, opts):
        """The bound of one launch over ``lines``: the bytes it must move
        (the line columns read once, 4 B a word; each register cell it
        changes read and written once, 16 B; each table slot it fills
        written once, 8 B; the key table read once) and its operations
        (the hashing of every valid line plus one for each register
        update)."""
        tb, hb = talk0.clone(), hll0.clone()
        _, cnt, rep = tail_call(reg_tail.reg_tail, tb, hb, lines, lines["valid"], **opts)
        changed = int((tb != talk0).sum()) + int((hb != hll0).sum())
        filled = 0 if cnt is None else int((cnt != 0).sum()) + int((rep >= 0).sum())
        limbs = len(lines["src"])
        nbytes = (4 * (3 + limbs) * FULL_B + 16 * changed + 8 * filled
                  + 4 * lines["key_k"].shape[0])
        keys = reg_tail.line_keys(lines["row"], lines["acl"], lines["key_k"], lines["n_rows"])
        nz = lines["valid"] != 0
        inr = nz & (keys < n_keys)
        updates = (int(nz.sum()) * (sk.talk_cms_depth + (2 if opts["select"] else 0))
                   + int(inr.sum()) * (2 if opts["counts"] else 1))
        per_line = (OPS_TAIL_LINE + OPS_TAIL_ROW * sk.talk_cms_depth
                    + (OPS_TAIL_FOLD if limbs > 1 else 0))
        nops = per_line * int(nz.sum()) + updates
        return bound_row(ms, plain, nbytes, nops), nbytes, changed, updates, (cnt, rep)

    # times and bounds, by device_ms a call (CUDA events around calls queued
    # back to back; CUDA events around one call at a time also count the
    # wrapper's host time, which exceeds the kernel's: they are printed
    # beside it), medians of three rounds of 20.
    # The default step's tail is the scan route (the counts delta in the
    # kernel); the fused route's match kernel gives the delta.
    fused = dict(counts=False, select=True, sample_shift=0, salt=5)
    scan = dict(counts=True, select=True, sample_shift=0, salt=5)

    def timed(what, lines_, opts, force_global=False, plain_too=False):
        talk, hll = talk0.clone(), hll0.clone()

        def launch():
            return tail_call(reg_tail.reg_tail, talk, hll, lines_, lines_["valid"],
                             force_global=force_global, **opts)

        rounds = [device_ms(launch, 20) for _ in range(3)]
        ms = sorted(rounds)[1]
        plain = plain_ev = None
        if plain_too:
            def launch_plain():
                return tail_call(reg_tail.reg_tail_plain, talk, hll, lines_, lines_["valid"],
                                 **opts)

            plain = plain_ms(launch_plain, 3)
            plain_ev = cuda_ms(launch_plain, 2, warmup=1)
        events = sorted(cuda_ms(launch, 20) for _ in range(3))[1]
        row, nbytes, changed, updates, tables = bound(lines_, ms, plain or 0.0, opts)
        say(f"kernel reg_tail, {what}: B={FULL_B}, {n_keys} keys: {ms:.4f} ms of device time "
            f"a call (the kernel and the wrapper's fills, calls queued back to back; rounds "
            + " ".join(f"{x:.4f}" for x in rounds) + f"), bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({nbytes} bytes, {changed} "
            f"register cells changed, {updates} register updates), share of bound "
            f"{row['bound_ms'] / ms:.3f}; by CUDA events a call {events:.4f} ms"
            + (f"; plain torch {plain:.3f} ms of device time a call by the profiler "
               f"({plain_ev:.3f} ms by events)" if plain_too else "")
            + f"; nvidia-smi clocks.sm, power.draw, "
            f"temperature: {gpu_clocks()}; on {card}")
        return row, ms, tables

    row, uni_ms, (cnt, rep) = timed("scan route (the default: counts delta in the kernel, "
                                    "block histograms)", lines, scan, plain_too=True)
    fused_row, fused_ms, _ = timed("fused route (delta from match_hist)", lines, fused)
    timed("fused route, a deferred chunk (no candidate table)", lines,
          dict(fused, select=False))
    timed("scan route, global-atomic counts (force_global)", lines, scan, force_global=True)
    timed("v6 lines (four limbs folded in the kernel), scan route", lines6, scan)
    _, skew_ms, _ = timed("Zipf(1.2) over 1024 flows, scan route", skew, scan)
    _, skew_fused_ms, _ = timed("Zipf(1.2) over 1024 flows, fused route", skew, fused)
    _, one_ms, _ = timed("one talker on every line, scan route", one, scan)
    say(f"kernel reg_tail: skewed / uniform {skew_ms / uni_ms:.2f} (scan route), "
        f"{skew_fused_ms / fused_ms:.2f} (fused route); one talker / uniform "
        f"{one_ms / uni_ms:.2f}; on {card}")

    # the select: one launch of the select kernel over the default chunk's
    # table (and nothing else on the device); its device time a call, its
    # plain version's (the rank key, torch.topk and the gathers in torch)
    # by the profiler, and both by CUDA events a call
    k = sk.topk_chunk_candidates
    pargs = (cnt, rep, lines["acl"], lines["src"], talk0, k)
    sel = [device_ms(lambda: reg_tail.select_tables(*pargs, salt=5), 20) for _ in range(3)]
    pms = sorted(sel)[1]
    ran, _n = profiled(lambda: reg_tail.select_tables(*pargs, salt=5), 20)
    check(all("select_kernel" in name for name in ran),
          f"select_tables ran device work besides the select kernel: {sorted(ran)}")
    pplain = plain_ms(lambda: reg_tail.select_tables_plain(*pargs, salt=5), 20)
    call_ev = sorted(cuda_ms(lambda: reg_tail.select_tables(*pargs, salt=5), 20)
                     for _ in range(3))[1]
    plain_ev = sorted(cuda_ms(lambda: reg_tail.select_tables_plain(*pargs, salt=5), 20)
                      for _ in range(3))[1]
    big_k = reg_tail.select_rank_cap() + 1
    big_ms = device_ms(lambda: reg_tail.select_tables(cnt, rep, lines["acl"], lines["src"],
                                                      talk0, big_k, salt=5), 5)
    # the select reads the slot table (cnt) once and, per candidate, its
    # slot's rep, its line's acl and src, its talker-CMS cells, and writes
    # three words; the rank key is ~4 operations a slot, a candidate ~60
    pbytes = slots * 8 + k * (8 + 2 * 4 + 8 * sk.talk_cms_depth + 3 * 8)
    pops = slots * 4 + k * 60
    prow = bound_row(pms, pplain, pbytes, pops)
    say(f"kernel select: select_tables over {slots} slots, k={k}: {pms:.4f} ms of device time "
        f"a call (calls queued back to back), all of it the select kernel (one launch), "
        f"against {pplain:.4f} ms for select_tables_plain (rank key, torch.topk, gathers) by "
        f"the profiler; bound "
        f"{prow['bound_ms']:.6f} ms by {prow['bound_by']}, share {prow['bound_ms'] / pms:.4f}; "
        f"by CUDA events a call {call_ev:.4f} ms against {plain_ev:.4f} ms; k={big_k} (two "
        f"launches) {big_ms:.4f} ms; on {card}")
    return {"reg_tail": (row, err["reg_tail"]), "select": (prow, err["select"])}


#: rounds device_ms takes before the script fails
TRIES = 3
#: windows profiled takes before the script fails: the profiler leaves a
#: whole window empty now and then, and late in a long process every short
#: window of the select's calls (PERF.md section 7), so the windows grow
PROFILE_WINDOWS = 8
#: the SM clock at most (Hz): sizes device_ms's spin kernel, which holds
#: the card at least as long on a slower clock
SPIN_HZ = 1.98e9


def device_ms(fn, iters: int) -> float:
    """ms of the card's work a call of fn(), by CUDA events around `iters`
    calls queued back to back: a spin kernel holds the card while the host
    queues them, so the events time the card and not the host (a kernel
    shorter than its wrapper's host time is timed as the kernel).  A round
    in which the card reached the calls before the last was queued (fn()
    waited on the card, or the spin was too short) is taken again with a
    spin four times longer, up to TRIES rounds; then the script fails.
    (torch.profiler's device time is not used: on the H100's machine it
    dropped the records of whole calls from its windows, PERF.md section
    7.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spin = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for attempt in range(1, TRIES + 1):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(spin * SPIN_HZ))
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        queued = not e0.query()  # the card still spinning: every call was queued in time
        torch.cuda.synchronize()
        if queued:
            return e0.elapsed_time(e1) / iters
        say(f"device_ms: the card reached the calls before the host had queued them (spin "
            f"{spin * 1e3:.1f} ms), round {attempt} of {TRIES} taken again")
        spin *= 4
    raise Check("device_ms: the host could not queue the calls ahead of the card")


def profiled(fn, iters: int) -> tuple[dict, int]:
    """{kernel name: (records, us)} of the card's work over n calls of fn(),
    from a torch.profiler window, and n.  n starts at `iters`; a window with
    no device record is said so and taken again, with four times the calls
    while a window takes under half a second, up to PROFILE_WINDOWS
    windows.  Used to name what a call launches
    and for the plain versions' device time, never for a kernel's time:
    the profiler drops records (device_ms), so a plain time may read low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = iters
    for attempt in range(1, PROFILE_WINDOWS + 1):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if out:
            if attempt > 1:
                say(f"profiled: window {attempt} ({n} calls) recorded {len(out)} kernels")
            return out, n
        say(f"profiled: window {attempt} of {PROFILE_WINDOWS} ({n} calls, {wall:.3f} s) "
            "recorded no device time")
        if wall < 0.5:
            n *= 4
    raise Check(f"the profiler recorded no device time in {PROFILE_WINDOWS} windows")


def plain_ms(fn, iters: int) -> float:
    """ms of device time a call of a plain version, from `profiled`."""
    out, n = profiled(fn, iters)
    return sum(us for _, us in out.values()) / 1e3 / n


def bound_row(ms: float, plain: float, nbytes: int, nops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_SEC * 1e3
    t_ops = nops / INT32_OPS_PER_SEC * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


#: the step variants of the update-paths phase: name -> analysis_step
#: options.  The reference's other update-path flags (sorted, matmul,
#: reduce) run this same tail in the port, so they are not stepped apart.
STEP_VARIANTS = {
    "scan + scatter (reg_tail; the default)": dict(match_impl="scan"),
    "fused + scatter (reg_tail)": dict(match_impl="fused"),
    "scan + topk_every 4": dict(match_impl="scan", topk_every=4),
    "fused + topk_every 4": dict(match_impl="fused", topk_every=4),
}


def phase_step_variants(dev, card: str) -> dict:
    """Every update path's device step at B = 2^20 wire lines resident on the
    card (16x256): wall, device busy, ops a step, idle share; the registers
    of every variant equal the first one's after the same steps."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline

    cfg = AnalysisConfig(batch_size=FULL_B)
    _, packed = ruleset(*SHAPES[1])
    tuples = synth.synth_tuples(packed, FULL_B, seed=3)
    wire = torch.from_numpy(
        pack.compact_batch(np.ascontiguousarray(tuples.T)).view(np.int32)).to(dev)
    rules = pipeline.ship_ruleset(packed, dev)
    steps = 8
    first, out = None, {}
    for name, kw in STEP_VARIANTS.items():
        state = pipeline.init_state(packed.n_keys, cfg, dev)

        def step(salt):
            return pipeline.analysis_step(state, rules, wire, n_keys=packed.n_keys,
                                          topk_k=cfg.sketch.topk_chunk_candidates, salt=salt,
                                          **kw)[0]

        state = step(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, steps + 1):
            state = step(s)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps * 1e3
        b = breakdown(step, steps, dt, f"variant {name}, 16x256", "reg_tail_kernel")
        regs = pipeline.state_to_numpy(state)
        if first is None:
            first = regs
        for k, v in regs.items():
            check(bool((v == first[k]).all()), f"variant {name}: register {k} differs from "
                  f"{next(iter(STEP_VARIANTS))}'s")
        out[name] = dict(wall_ms=dt, **(b or {}))
        say(f"step variant {name}: B={FULL_B}, 16x256: wall {dt:.3f} ms/step, "
            + (f"device busy {b['busy_ms']:.3f} ms/step, {b['ops']:.0f} device ops/step, idle "
               f"share {b['idle']:.3f}" if b else "device time not measured")
            + f"; registers == the first variant's after {2 * steps + 1} steps; on {card}")
    return out


def phase_cli_variants(work: str, card: str) -> dict:
    """`run` over the ingest phase's 16x256 text and wire files under the
    reference's update-path flags: each Report equals the default run's;
    --topk-every 4 keeps per-rule counts and unused rules."""
    from collections import Counter

    d = os.path.join(work, "ingest")
    prefix = os.path.join(d, "fw1")
    launches = Counter()
    for kind, logs, batch in (("text", os.path.join(d, "fw1.log"), 1 << 18),
                              ("wire", os.path.join(d, "fw1.rawire"), FULL_B)):
        runs = {}
        for name, impl, extra in (
            ("default", None, ()),
            ("--update-impl sorted --counts-impl reduce", "scan",
             ("--update-impl", "sorted", "--counts-impl", "reduce")),
            ("--counts-impl matmul", "scan", ("--counts-impl", "matmul")),
            ("--topk-every 4", "fused", ("--topk-every", "4")),
        ):
            runs[name], n = cli_run(prefix, logs, impl, batch, extra, tag=f"-v{len(runs)}")
            launches.update(n)
            t = runs[name]["totals"]
            say(f"update paths, {kind}: {name}: sustained_lines_per_sec "
                f"{t['sustained_lines_per_sec']}, chunks {t['chunks']}, elapsed_sec "
                f"{t['elapsed_sec']}, launches {n}; on {card}")
        base = strip(runs["default"])
        for name in ("--update-impl sorted --counts-impl reduce", "--counts-impl matmul"):
            check(strip(runs[name]) == base, f"{kind}: {name} report != the default's")
        every = strip(runs["--topk-every 4"])
        check(every["per_rule"] == base["per_rule"] and every["unused"] == base["unused"],
              f"{kind}: --topk-every 4 changed per-rule counts or unused rules")
        check(bool(every["talkers"]), f"{kind}: --topk-every 4 surfaced no talkers")
        say(f"update paths, {kind}: the sorted/reduce and matmul flags' reports == the "
            "default's; --topk-every 4: per-rule counts and unused == the default's, talkers "
            "surface")
    return dict(launches)


def breakdown(step, steps: int, wall_ms: float, what: str, kernel: str) -> None:
    """Where the step's device time goes: torch.profiler over a few steps.

    Busy time sums the device-side events only (kernels, copies, sets):
    the profiler also charges each kernel's time to the aten op that
    launched it.  The idle share, and the match kernel's (`kernel`)
    share, are taken against the step's wall time measured without the
    profiler (`wall_ms`).
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
        say(f"device step breakdown ({what}): the profiler recorded no device time "
            "(not measured)")
        return None
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps  # ms per step
    launches = sum(e.count for e in events) / steps
    match_ms = sum(e.self_device_time_total for e in events if kernel in e.key) / 1e3 / steps
    check(match_ms > 0, f"the profiler saw no {kernel} in the {what} step")
    say(f"device step breakdown ({what}, {steps} steps): device busy {busy:.3f} ms/step in "
        f"{launches:.0f} device ops/step; step wall {wall_ms:.3f} ms without the profiler, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}; {kernel} {match_ms:.4f} ms/step, "
        f"{match_ms / busy:.3f} of device busy, {match_ms / wall_ms:.3f} of the step wall")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        say(f"  {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  {e.count / steps:5.1f}x  "
            f"{e.key[:100]}")
    return {"busy_ms": busy, "ops": launches, "idle": max(0.0, 1 - busy / wall_ms)}


MESH_SHARDS = (1, 2, 4, 8)
MESH_CHUNKS = 3


def mesh_batches(kind: str) -> list:
    """MESH_CHUNKS host batches of ``kind`` at B = 2^20 global lines on the
    16x256 ruleset (the dual-stack one for v6), as the sharded steps take
    them: wire layouts, a weighted wire batch (weights 1..1000, a coalesced
    batch's repetition counts), grouped [16, TUPLE_COLS, 2^16] batches."""
    import numpy as np

    from ruleset_analysis_tpu_torch.hostside import pack, synth

    out = []
    for c in range(MESH_CHUNKS):
        seed = 21 + c
        if kind == "v6":
            _, packed = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
            t6 = np.ascontiguousarray(synth.synth_tuples6(packed, FULL_B, seed=seed).T)
            out.append(pack.compact_batch6(t6))
            continue
        _, packed = ruleset(*SHAPES[1])
        if kind == "stacked":
            t = synth.synth_tuples(packed, 2 * FULL_B, seed=seed)
            out.append(pack.GroupBuffer(packed.n_acls, FULL_B // packed.n_acls).add(t)[0])
            continue
        t = np.ascontiguousarray(synth.synth_tuples(packed, FULL_B, seed=seed).T)
        if kind == "weighted":
            w = np.random.default_rng(seed).integers(1, 1001, FULL_B).astype(np.uint32)
            t[pack.T_VALID] = np.where(t[pack.T_VALID] > 0, w, 0)
            out.append(pack.compact_batch_w(t))
        else:
            out.append(pack.compact_batch(t))
    return out


def phase_mesh(dev, card: str) -> dict:
    """The sharded step (parallel/step.py) on meshes of 1, 2, 4 and 8 virtual
    shards on one card.

    Each mesh steps MESH_CHUNKS chunks of 2^20 lines (salts 0, 1, 2 with
    topk_every 2: the middle chunk defers selection) of every kind; its
    registers must equal the one-shard mesh's, and its registers and
    [n * k] candidates the same mesh's plain versions on the CPU
    ([cpu] * n, fed each shard's match rows and lines copied to the host).
    Prints ms a step and the merge's ms at each width.
    """
    import importlib

    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib
    from ruleset_analysis_tpu_torch.parallel import step as step_lib

    counters = {k: getattr(importlib.import_module(f"ruleset_analysis_tpu_torch.ops.{m}"), f)
                for k, (m, f) in COUNTERS.items()}
    launches = {k: 0 for k in counters}
    cpu = torch.device("cpu")

    def counted(fn, *args):
        before = {k: f.launches for k, f in counters.items()}
        out = fn(*args)
        for k, f in counters.items():
            launches[k] += f.launches - before[k]
        return out

    def lines_to(m, d):
        return pipeline.Lines(m.row.to(d), m.valid.to(d), m.acl.to(d),
                              tuple(x.to(d) for x in m.src), m.key_k.to(d), m.n_rows,
                              m.acl_tag, None if m.counts_delta is None
                              else m.counts_delta.to(d))

    cfg = AnalysisConfig(batch_size=FULL_B, sketch=SketchConfig(topk_every=2))
    kw = dict(topk_k=cfg.sketch.topk_chunk_candidates, exact_counts=True, topk_every=2)
    for kind in ("scan", "fused", "weighted", "v6", "stacked"):
        _, packed = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION if kind == "v6" else 0.0)
        batches = mesh_batches(kind)
        c = cfg if kind != "fused" else AnalysisConfig(batch_size=FULL_B, match_impl="fused",
                                                       sketch=cfg.sketch)
        one = None
        for n in MESH_SHARDS:
            t0 = time.perf_counter()
            mesh = mesh_lib.make_mesh([dev] * n)
            cmesh = mesh_lib.make_mesh([cpu] * n)
            if kind == "v6":
                step = step_lib.make_parallel_step6(mesh, c, packed.n_keys)
                rules, crules = step_lib.ship6(packed, mesh), step_lib.ship6(packed, cmesh)
            else:
                step = step_lib.make_parallel_step(mesh, c, packed.n_keys)
                rules, crules = step_lib.ship(packed, mesh), step_lib.ship(packed, cmesh)
            state = step_lib.init_state(packed.n_keys, c, mesh)
            cstate = step_lib.init_state(packed.n_keys, c, cmesh)
            for salt, b in enumerate(batches):
                shards = [s.use() for s in (
                    mesh_lib.shard_grouped(mesh, b, False) if kind == "stacked"
                    else mesh_lib.shard_batch(mesh, b))]
                state, out = counted(step, state, rules, shards, salt)
                # the plain versions: the same shards' match rows and lines
                # (the match kernels are held to theirs elsewhere), the tail,
                # merges and select on the CPU
                lines = [lines_to(pipeline.match_lines6(rules[0], s) if kind == "v6"
                                  else pipeline.match_lines(rules[0], s, n_keys=packed.n_keys,
                                                            match_impl=c.match_impl), cpu)
                         for s in shards]
                cstate, cout = step_lib.merge_tail(cstate, cmesh, lines, n_keys=packed.n_keys,
                                                   salt=salt, **kw)
                err = max_abs_err([x.cpu() for x in out], list(cout))
                check(err == 0, f"mesh {kind} x{n} chunk {salt}: candidates differ from the "
                                f"plain versions on the CPU (max abs err {err})")
                check(out.cand_acl.shape[0] == cout.cand_acl.shape[0],
                      f"mesh {kind} x{n}: {out.cand_acl.shape[0]} candidates")
            regs = pipeline.state_to_numpy(state[0])
            cregs = pipeline.state_to_numpy(cstate[0])
            for f, v in regs.items():
                check(np.array_equal(v, cregs[f]), f"mesh {kind} x{n}: {f} != the CPU's")
                if one is not None:
                    check(np.array_equal(v, one[f]), f"mesh {kind} x{n}: {f} != one shard's")
            if one is None:
                one = regs
            # ms a step (a selecting chunk), and the merge's ms alone
            shards = [s.use() for s in (
                mesh_lib.shard_grouped(mesh, batches[0], False) if kind == "stacked"
                else mesh_lib.shard_batch(mesh, batches[0]))]
            step_ms = cuda_ms(lambda: step(state, rules, shards, 0), 5)
            if n == 1:
                merge = "merge: none (one shard: the one-device step)"
            else:
                lines = [pipeline.match_lines6(rules[0], s) if kind == "v6"
                         else pipeline.match_lines(rules[0], s, n_keys=packed.n_keys,
                                                   match_impl=c.match_impl) for s in shards]
                counts, talks, _ = step_lib.shard_tails(state, mesh, lines)
                merge_ms = cuda_ms(lambda: step_lib.merge_registers(
                    state, mesh, counts, talks, n_keys=packed.n_keys, exact_counts=True), 10)
                cands = [(x, x, x) for x in torch.zeros(n, 64, dtype=torch.int64, device=dev)]
                gather_ms = cuda_ms(lambda: step_lib.gather_candidates(mesh, cands), 10)
                merge = (f"merge {merge_ms:.4f} ms (counts and talker sums, HLL max, add64, key "
                         f"CMS, talker add), candidate gather {gather_ms:.4f} ms")
            say(f"mesh {kind} x{n} virtual shards on one card: B={FULL_B} ({FULL_B // n} a "
                f"shard), {MESH_CHUNKS} chunks: registers == one shard's and == the plain "
                f"versions on the CPU ([cpu] x {n}), candidates [{out.cand_acl.shape[0]}] == "
                f"the CPU's; {step_ms:.4f} ms a step, {merge}; on {card} "
                f"({time.perf_counter() - t0:.1f} s)")
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        _, packed = ruleset(*SHAPES[1])
        mesh = mesh_lib.make_mesh()
        step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
        state = step_lib.init_state(packed.n_keys, cfg, mesh)
        rules = step_lib.ship(packed, mesh)
        batches = mesh_batches("scan")
        for salt, b in enumerate(batches):
            state, _ = counted(step, state, rules,
                               [s.use() for s in mesh_lib.shard_batch(mesh, b)], salt)
        one_mesh = mesh_lib.make_mesh([dev])
        ostate = step_lib.init_state(packed.n_keys, cfg, one_mesh)
        ostep = step_lib.make_parallel_step(one_mesh, cfg, packed.n_keys)
        orules = step_lib.ship(packed, one_mesh)
        for salt, b in enumerate(batches):
            ostate, _ = ostep(ostate, orules, [s.use() for s in mesh_lib.shard_batch(one_mesh, b)],
                              salt)
        regs, oregs = pipeline.state_to_numpy(state[0]), pipeline.state_to_numpy(ostate[0])
        check(all(np.array_equal(regs[f], oregs[f]) for f in regs),
              f"the {n_dev}-device mesh's registers differ from one device's")
        say(f"mesh: {n_dev} CUDA devices: the scan step's registers == one device's")
    else:
        say(f"mesh: one CUDA device visible (torch.cuda.device_count() == {n_dev}): no "
            "multi-GPU step was run and no multi-GPU rate is measured")

    return launches


COUNTERS = {"first_match": ("first_match", "first_match_rows"),
            "match_hist": ("match_hist", "match_rows_and_hists"),
            "first_match6": ("first_match6", "first_match_rows6"),
            "reg_tail": ("reg_tail", "reg_tail"), "select": ("reg_tail", "select_tables")}


def counted_cli(counts_path: str, argv: list) -> int:
    """``python3 chip_smoke.py --counted-cli COUNTS -- ARGS``: the port's CLI
    with ARGS in this process, its kernels' launch counters zeroed before
    and written to COUNTS (JSON) after; exits with the CLI's code."""
    import importlib

    from ruleset_analysis_tpu_torch import cli

    fns = {k: getattr(importlib.import_module(f"ruleset_analysis_tpu_torch.ops.{m}"), f)
           for k, (m, f) in COUNTERS.items()}
    for fn in fns.values():
        fn.launches = 0
    rc = cli.main(argv)
    with open(counts_path, "w", encoding="utf-8") as fh:
        json.dump({k: fn.launches for k, fn in fns.items()}, fh)
    return rc


def child_run(what: str, args: list, out: str) -> tuple[dict, dict, float]:
    """One `run` of the port's CLI in a process of its own (`--counted-cli`):
    its report, its kernels' launch counts and the process's wall seconds."""
    counts = out[:-len(".json")] + "-launches.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--counted-cli", counts, "--",
         "run", *args, "--json", "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(counts, encoding="utf-8") as fh:
        n = json.load(fh)
    with open(out, encoding="utf-8") as fh:
        rep = json.load(fh)
    t = rep["totals"]
    check(t["backend"] == "torch-cuda", f"{what}: backend {t['backend']}")
    check(n["first_match"] == t["chunks"] and n["reg_tail"] == t["chunks"]
          and 0 < n["select"] <= t["chunks"], f"{what}: {n} launches over {t['chunks']} chunks")
    return rep, n, wall


def phase_distributed(work: str, card: str, ing: dict) -> dict:
    """`run --distributed` as a one-rank NCCL job, launched as a user
    launches it: a process of its own (which forms and destroys its
    communicator), over the ingest cell's text and plain `.rawire` files;
    its report must equal the plain run's, run in a process of its own as
    well, so both rates carry one process start.  Launches are those
    processes' counters."""
    import socket

    import torch

    say(f"distributed: NCCL {'.'.join(str(v) for v in torch.cuda.nccl.version())}")
    launches = {k: 0 for k in COUNTERS}
    d = os.path.dirname(ing["prefix"])
    for what, logs, batch in (("text", ing["logs"], 1 << 18),
                              ("plain wire", os.path.join(d, "fw1.rawire"), FULL_B)):
        args = ["--ruleset", ing["prefix"], "--logs", logs, "--batch-size", str(batch)]
        plain, n_plain, wall_plain = child_run(
            f"run ({what})", args, os.path.join(d, f"report-dist-plain-{batch}.json"))
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        rep, n, wall = child_run(
            f"run --distributed ({what})",
            [*args, "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "1", "--process-id", "0"],
            os.path.join(d, f"report-distributed-{batch}.json"))
        for counts in (n_plain, n):
            for k, v in counts.items():
                launches[k] += v
        t = rep["totals"]
        check(t["processes"] == 1, f"run --distributed ({what}): processes {t['processes']}")
        a, b = strip(rep), strip(plain)
        for r in (a, b):
            # the distributed totals carry the wire file's raw-line
            # accounting, not its row counts (as the reference's do)
            for k in ("backend", "processes", "wire_rows", "wire_evals", "wire_weighted"):
                r["totals"].pop(k, None)
        check(a == b, f"run --distributed ({what}) report differs from the plain run's")
        say(f"distributed: run --distributed --num-processes 1 (one-rank NCCL group), {what}, "
            f"batch {batch}: report == the plain run's (but VOLATILE_TOTALS, backend, "
            f"processes); {t['lines_total']} lines, {t['chunks']} chunks; each run in a process "
            f"of its own: sustained_lines_per_sec {t['sustained_lines_per_sec']} (process wall "
            f"{wall:.1f} s), plain run {plain['totals']['sustained_lines_per_sec']} (process "
            f"wall {wall_plain:.1f} s); launches {n}, plain {n_plain}; on {card}")
    return launches


#: integer operations a pair of the relation_grid kernel (counted from
#: csrc/relation_tile.cu): the acl compare, two compares a field for
#: covered and two for overlap, the staged row's lo <= hi flag, one OR a
#: set bit for each matrix; the ands fold into the compares' predicates.
#: (The first design's count, 43, took the overlap test as max, min and a
#: compare a field and counted each and; the redesigned kernel runs
#: faster than 43 would allow.)
OPS_PER_PAIR = 24
#: the static phase's tile edge: the analyzer's default (ops/overlap.PAIR_TILE)
STATIC_TILE = 512


def static_run(args: list, counters: dict) -> tuple[int, dict, str]:
    """One CLI call in this process with the launch counters zeroed around
    it: (exit code, launches, what it printed to stderr); the relation_grid
    kernel's tiles under "relation_tiles"."""
    import contextlib
    import io

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.ops import overlap

    for fn in counters.values():
        fn.launches = 0
    overlap.relation_grid.tiles = 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    counts = {k: fn.launches for k, fn in counters.items()}
    counts["relation_tiles"] = overlap.relation_grid.tiles
    return rc, counts, err.getvalue()


def real_pairs(blocks, work, tile: int) -> int:
    """Pairs of two real rows (not NO_ACL padding) over a work list's tiles:
    the pairs whose relations the data needs computed."""
    from ruleset_analysis_tpu_torch.hostside.pack import R_ACL

    real = (blocks[:, R_ACL] != -1).view(-1, tile).sum(1).cpu().numpy().astype(int)
    w = work.numpy()
    return int((real[w[:, 0]] * real[w[:, 1]]).sum())


def grid_bound(blocks, work, tile: int, ms: float, plain: float) -> dict:
    """bound_row of one relation_grid launch: each row block read once, the
    work list, both word arrays written once; OPS_PER_PAIR a pair of two
    real rows (a padding row relates to nothing)."""
    n_t = work.shape[0]
    words = -(-tile // 32)
    nbytes = blocks.shape[0] * 48 + n_t * 8 + 2 * n_t * words * tile * 4
    return bound_row(ms, plain, nbytes, OPS_PER_PAIR * real_pairs(blocks, work, tile))


def analysis_work(packed, dev, tile: int = STATIC_TILE):
    """The relation_grid inputs `analyze_ruleset` launches for `packed` (no
    reuse): every ACL's rows as a slab, in gid order, its lower tiles
    (overlap.grid_work), the padded blocks on the card."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside.pack import R_ACL
    from ruleset_analysis_tpu_torch.ops import overlap

    acl = packed.rules[:, R_ACL]
    slabs = [packed.rules[acl == g] for g in range(packed.n_acls)]
    _, [(index, work)] = overlap.grid_work([s.shape[0] for s in slabs], tile, lower_only=True)
    blocks = np.concatenate([overlap._pad_rows(slabs[s][b0:b0 + tile], tile)
                             for s, b0 in index])
    return (torch.from_numpy(np.ascontiguousarray(blocks).view(np.int32)).to(dev),
            torch.from_numpy(work), tile)


def phase_relation(dev, card: str) -> dict:
    """The relation_grid kernel on the card: bit-identical to its plain
    version on the edge tiles (and relation_tile's bools to
    relation_tile_plain's) and on the work lists the analyzer launches for
    the three rulesets of the static phase; then its device time a launch
    (device_ms, medians of three rounds of 20) with its bound and share for
    one 512 x 512 tile, the 2048-rule ACL's 28-tile launch and the 16x256
    analysis's 18-tile launch; CUDA events around the wrapper and around
    pair_relations.  Returns the kernel's row (the 28-tile launch), its max
    abs err and each analysis's tiles."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth
    from ruleset_analysis_tpu_torch.hostside.pack import R_ACL
    from ruleset_analysis_tpu_torch.ops import _build, overlap

    text = synth.synth_config(n_acls=1, rules_per_acl=2048, seed=2048)
    packed2048 = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    rules2048 = packed2048.rules
    check(rules2048.shape[0] == 3335, f"the 2048-rule ACL has {rules2048.shape[0]} rows")

    def on_card(rows):
        return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(dev)

    def same_words(blocks, work, tile, what) -> int:
        want = overlap.relation_grid_plain(blocks, work, tile)
        got = overlap.relation_grid(blocks, work, tile)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0 and all(g.dtype == torch.int32 and g.shape == w.shape
                             for g, w in zip(got, want)),
              f"relation_grid differs from its plain version on {what} (max abs err {e})")
        return e

    # (a) the edge tiles: relation_tile's bools, and the tile as a work list
    # (both ways round and against itself) in words
    err = 0
    for name, (ri, rj) in synth.relation_edge_cases(rules2048).items():
        a, b = on_card(ri), on_card(rj)
        got = overlap.relation_tile(a, b)
        want = overlap.relation_tile_plain(a, b)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0 and all(g.dtype == torch.bool for g in got),
              f"relation_tile differs from its plain version on {name} (max abs err {e})")
        t = max(ri.shape[0], rj.shape[0])
        blocks = on_card(np.concatenate([overlap._pad_rows(ri, t), overlap._pad_rows(rj, t)]))
        work = torch.tensor([[0, 1], [1, 0], [1, 1]], dtype=torch.int32)
        err = max(err, e, same_words(blocks, work, t, name))
        say(f"relation: edge tile {name} ({ri.shape[0]} x {rj.shape[0]}): relation_tile and "
            "relation_grid bit-identical to plain")

    # (b) the analyzer's own work lists, one launch an analysis
    grids, tiles = {}, {}
    for what, packed in (("16x256", ruleset(*SHAPES[1])[1]), ("2048 rules", packed2048),
                         ("dual-stack 16x256", ruleset(*SHAPES[1], V6_FRACTION)[1])):
        blocks, work, tile = grids[what] = analysis_work(packed, dev)
        err = max(err, same_words(blocks, work, tile, f"the {what} work list"))
        tiles[what] = work.shape[0]
        say(f"relation: analyze ({what}): {work.shape[0]} tiles over {blocks.shape[0] // tile} "
            f"row blocks ({int((blocks[:, R_ACL] != -1).sum())} real rows of "
            f"{blocks.shape[0]}); bit-identical to plain")

    # (c) device time, bound and share
    t = STATIC_TILE
    grids["one 512 x 512 tile"] = (on_card(np.concatenate([rules2048[t:2 * t],
                                                           rules2048[:t]])),
                                   torch.tensor([[0, 1]], dtype=torch.int32), t)
    rows = {}
    lib = _build.library("relation_tile")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what in ("one 512 x 512 tile", "2048 rules", "16x256"):
        blocks, work, tile = grids[what]
        n_t = work.shape[0]
        work_d = work.to(dev)
        out = torch.empty((2, n_t, overlap.words_of(tile), tile), dtype=torch.int32, device=dev)

        def call():
            return overlap.relation_grid(blocks, work, tile)

        def launch():
            # the kernel alone: the wrapper's C call on inputs already on
            # the card (the wrapper also copies the work list each call)
            _build.check(lib, lib.ra_relation_grid(blocks.data_ptr(), work_d.data_ptr(), n_t,
                                                   tile, out[0].data_ptr(), out[1].data_ptr(),
                                                   stream), "relation_grid launch")

        rounds = [device_ms(launch, 20) for _ in range(3)]
        ms = sorted(rounds)[1]
        call_ms = device_ms(call, 20)
        plain = plain_ms(lambda: overlap.relation_grid_plain(blocks, work, tile), 3)
        events = sorted(cuda_ms(call, 20) for _ in range(3))[1]
        row = rows[what] = grid_bound(blocks, work, tile, ms, plain)
        pairs = real_pairs(blocks, work, tile)
        t43 = 43 * pairs / INT32_OPS_PER_SEC * 1e3
        say(f"kernel relation_grid: {what} ({work.shape[0]} tiles of {tile}, "
            f"{overlap.grid_size(work.shape[0], tile)} blocks, {pairs} pairs of real rows of "
            f"{work.shape[0] * tile * tile}): {ms:.4f} ms of device time a launch (launches "
            f"queued back to back; rounds " + " ".join(f"{x:.4f}" for x in rounds)
            + f"; a wrapper call, the work list's copy too, {call_ms:.4f}), bound "
            f"{row['bound_ms']:.6f} ms by "
            f"{row['bound_by']}, share {row['bound_ms'] / ms:.4f} (at the first design's 43 "
            f"operations a pair {t43:.6f} ms, {t43 / ms:.4f}); plain torch {plain:.4f} ms of "
            f"device time a call by the profiler; the wrapper by CUDA events {events:.4f} ms a "
            f"call, one at a time; on {card}")

    # (d) pair_relations end to end (blocks built, copied, launched, each
    # slab unpacked on the card and copied back), by CUDA events
    acl = ruleset(*SHAPES[1])[1].rules
    slabs16 = [acl[acl[:, R_ACL] == g] for g in range(SHAPES[1][0])]
    for what, fn in (("2048 rules, pair_relations",
                      lambda: overlap.pair_relations(rules2048, devices=[dev], lower_only=True)),
                     ("16x256, pair_relations_many over its 16 ACLs",
                      lambda: list(overlap.pair_relations_many(slabs16, devices=[dev],
                                                               lower_only=True)))):
        ev = sorted(cuda_ms(fn, 5) for _ in range(3))[1]
        say(f"relation: {what}: {ev:.3f} ms a call by CUDA events; on {card}")
    return {"row": rows["2048 rules"], "err": err, "tiles": tiles}


def phase_static(work: str, dev, card: str, ing: dict, dual: dict, out: dict) -> dict:
    """Static analysis on the card: the relation_grid kernel phase
    (phase_relation); `analyze --json` through the CLI on the card and with
    --device cpu for three rulesets (the ingest phase's 16x256, one ACL of
    2048 rules, the dual-stack 16x256), one relation_grid launch each over
    the work list the kernel phase held to its plain version; `run
    --static-analysis` over the ingest corpus against the same run without
    it; a fired `analyze.tile` fault.  Puts the kernel's row in `out`;
    returns the launches of the analyses and the runs."""
    from collections import Counter

    from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth
    from ruleset_analysis_tpu_torch.hostside.pack import NO_ACL, R6_ACL, R6_KEY
    from ruleset_analysis_tpu_torch.ops import first_match, first_match6, match_hist, overlap
    from ruleset_analysis_tpu_torch.ops import reg_tail
    from ruleset_analysis_tpu_torch.runtime.report import VOLATILE_TOTALS

    d = os.path.join(work, "static")
    os.makedirs(d, exist_ok=True)
    text = synth.synth_config(n_acls=1, rules_per_acl=2048, seed=2048)
    packed2048 = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    prefix2048 = os.path.join(d, "acl2048")
    pack.save_packed(packed2048, prefix2048)

    # (a)-(b) the kernel against its plain version, and its times
    out.update(phase_relation(dev, card))

    # (c) analyze through the CLI, on the card and on the CPU
    # the kernel keeps its first name, relation_tile, in the kernels line
    counters = {"relation_tile": overlap.relation_grid,
                "first_match": first_match.first_match_rows,
                "first_match6": first_match6.first_match_rows6,
                "match_hist": match_hist.match_rows_and_hists, "reg_tail": reg_tail.reg_tail,
                "select": reg_tail.select_tables}
    launches = Counter()
    analyses = {}
    for what, prefix, grid in (("16x256", ing["prefix"], "16x256"),
                               ("one ACL of 2048 rules", prefix2048, "2048 rules"),
                               ("dual-stack 16x256", dual["prefix"], "dual-stack 16x256")):
        objs, walls, counts = {}, {}, {}
        for where in ("cuda", "cpu"):
            path = os.path.join(d, f"analyze-{len(analyses)}-{where}.json")
            t0 = time.perf_counter()
            rc, counts[where], msg = static_run(
                ["analyze", "--ruleset", prefix, "--device", where, "--json", "--out", path],
                counters)
            walls[where] = time.perf_counter() - t0
            check(rc == 0, f"analyze --device {where} ({what}) exited {rc}: {msg[-2000:]}")
            with open(path, encoding="utf-8") as fh:
                objs[where] = json.load(fh)
        n = counts["cuda"]
        seconds = objs["cuda"]["meta"].pop("duration_sec")
        objs["cpu"]["meta"].pop("duration_sec")
        m = objs["cuda"]["meta"]
        check(objs["cuda"] == objs["cpu"], f"analyze ({what}) on the card != --device cpu")
        check(not any(counts["cpu"].values()), f"analyze --device cpu launched {counts['cpu']}")
        # all the analysis's tiles in one relation_grid launch, the work
        # list the relation phase held to the plain version
        check(n["relation_tile"] == 1
              and n["relation_tiles"] == m["tiles_run"] == out["tiles"][grid] > 0,
              f"analyze ({what}): relation_grid launched {n['relation_tile']} times over "
              f"{n['relation_tiles']} of {m['tiles_run']} tiles (the relation phase's work "
              f"list: {out['tiles'][grid]})")
        check((n["first_match"] > 0) == (m["witnesses_checked"] > 0),
              f"analyze ({what}): first_match launched {n['first_match']} times for "
              f"{m['witnesses_checked']} witnesses")
        check(not any(n[k] for k in ("first_match6", "match_hist", "reg_tail", "select")),
              f"analyze ({what}) launched {n}")
        tiles = n.pop("relation_tiles")
        launches.update({k: v for k, v in n.items() if v})
        analyses[what] = (m, n)
        extra = ""
        if what.startswith("dual"):
            dp = pack.load_packed(prefix)
            v6_keys = {int(k) for k in dp.rules6[dp.rules6[:, R6_ACL] != NO_ACL, R6_KEY]}
            verdicts = {v["key_id"]: v["verdict"] for v in objs["cuda"]["verdicts"]}
            check(bool(v6_keys) and not any(verdicts[k] in ("shadowed", "redundant", "conflict")
                                            for k in v6_keys),
                  "a key with IPv6 rows came out dead")
            masked = sum(verdicts[k] == "partially-masked" for k in v6_keys)
            extra = (f"; {len(v6_keys)} keys with IPv6 rows, none dead, {masked} of them "
                     "partially-masked")
        say(f"static: analyze ({what}): {m['n_rows']} rows, {m['n_acls']} ACLs, tiles_run "
            f"{m['tiles_run']}, witnesses_checked {m['witnesses_checked']}, dead {m['dead']}, "
            f"verdicts {m['verdict_counts']}; the card's JSON == --device cpu's; wall "
            f"{walls['cuda']:.3f} s on the card (duration_sec {seconds}), {walls['cpu']:.3f} s "
            f"with --device cpu; launches relation_grid {n['relation_tile']} ({tiles} tiles), "
            f"first_match {n['first_match']}{extra}; on {card}")

    # (d) run --static-analysis over the ingest corpus, and the same run
    # without the flag
    meta16, n16 = analyses["16x256"]
    reps = {}
    for flag in ((), ("--static-analysis",)):
        path = os.path.join(d, f"run{'-static' if flag else ''}.json")
        rc, n, msg = static_run(["run", "--ruleset", ing["prefix"], "--logs", ing["logs"],
                                 "--batch-size", str(1 << 18), "--json", "--out", path, *flag],
                                counters)
        what = f"run {flag[0] if flag else '(no flag)'}"
        check(rc == 0, f"{what} exited {rc}: {msg[-2000:]}")
        with open(path, encoding="utf-8") as fh:
            rep = json.load(fh)
        tot = rep["totals"]
        check(tot["backend"] == "torch-cuda", f"{what}: backend {tot['backend']}")
        check(n["first_match"] == tot["chunks"] + (n16["first_match"] if flag else 0)
              and n["reg_tail"] == tot["chunks"]
              and n["relation_tile"] == (1 if flag else 0)
              and n["relation_tiles"] == (meta16["tiles_run"] if flag else 0),
              f"{what}: launches {n} over {tot['chunks']} chunks")
        n.pop("relation_tiles")
        launches.update({k: v for k, v in n.items() if v})
        reps[flag] = rep
        say(f"static: {what}, {tot['lines_total']} lines, batch 2^18: "
            f"sustained_lines_per_sec {tot['sustained_lines_per_sec']}, launches {n}; on {card}")
    joined, plain_rep = reps[("--static-analysis",)], reps[()]
    st = joined["totals"].pop("static")
    st_meta = dict(st["meta"])
    st_meta.pop("duration_sec")
    check(st_meta == meta16, "run --static-analysis: totals.static.meta != analyze's")
    check(sum(len(v) for v in st["unused_classes"].values()) == len(joined["unused"]),
          "run --static-analysis: the unused classes do not partition the unused rules")
    for e in joined["per_rule"]:
        for k in ("verdict", "verdict_basis", "verdict_certified"):
            e.pop(k, None)
    for r in (joined, plain_rep):
        for k in VOLATILE_TOTALS:
            r["totals"].pop(k, None)
    check(joined == plain_rep, "run --static-analysis report != the run without it")
    classes = {k: len(v) for k, v in st["unused_classes"].items()}
    say(f"static: run --static-analysis == the run without it (but the static fields and "
        f"VOLATILE_TOTALS); its totals.static.meta == analyze's; unused classes {classes}")

    # (e) a fired analyze.tile fault: exit 1, the fault named, no --out file
    path = os.path.join(d, "faulted.json")
    rc, n, msg = static_run(["analyze", "--ruleset", ing["prefix"], "--fault-plan",
                             "analyze.tile@2", "--json", "--out", path], counters)
    # every tile's seam fires before the one launch: the fault leaves none
    check(rc == 1 and "injected fault: analyze.tile (hit 2)" in msg
          and not os.path.exists(path) and "RA_FAULT_PLAN" not in os.environ
          and n["relation_tile"] == 0 and n["relation_tiles"] == 0,
          f"analyze --fault-plan analyze.tile@2: rc {rc}, launches {n}, stderr {msg[-500:]!r}")
    say(f"static: analyze --fault-plan analyze.tile@2: exit 1 with no relation_grid launch, "
        f"{msg.strip()!r}, no --out file")
    return dict(launches)


#: the faults phase's batch: four chunks of phase_full_width's corpus
FAULTS_B = 1 << 18
#: span and instant names of the reference's trace of a prefetched native
#: text run (the ones every such run has, then the timing-dependent ones)
TRACE_NAMES = {"process_name", "ingest.produce", "ingest.pack", "step.dispatch"}
TRACE_NAMES_MAY = {"ingest.backpressure", "ingest.starved"}


def phase_faults(work: str, card: str) -> dict:
    """The run path's failure handling on the card, through the CLI.

    16x256 ruleset, phase_full_width's 2^20 text lines at batch 2^18 (four
    chunks).  A clean run; ``stream.device_put.fail@3:2`` on the
    synchronous loop, at prefetch depth 2 and through the ring feeder,
    each recovered by the device_put retry to the clean report (two
    retries, one recovery); ``@3:99``, which exits 1 with a postmortem
    that ``doctor`` names; a torn checkpoint recovered by the
    checkpoint.save retry; and ``--trace-out``.  The rate of the default
    run (recorder on) against ``--blackbox off``, in turns.
    """
    from collections import Counter

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.runtime import retrypolicy

    full = os.path.join(work, "full")
    prefix, logs = os.path.join(full, "fw1"), os.path.join(full, "fw1.log")
    d = os.path.join(work, "faults")
    os.makedirs(d, exist_ok=True)
    ck = os.path.join(d, "ck")
    bb = os.path.join(d, "blackbox")  # the default: beside the checkpoint dir
    batch = FAULTS_B
    launches = Counter()
    rates: dict[str, list] = {"default (recorder on)": [], "--blackbox off": []}

    def run(tag: str, *extra: str) -> dict:
        rep, n = cli_run(prefix, logs, None, batch, ("--checkpoint-dir", ck, *extra),
                         tag=f"-faults-{tag}")
        launches.update(n)
        check(rep["totals"]["lines_total"] == FULL_B, f"faults {tag}: not every line consumed")
        # worker seals may have made the dir; a clean exit prunes them all
        check(not os.path.isdir(bb) or not os.listdir(bb),
              f"faults {tag}: a run that ended well left forensics in {bb}")
        return rep

    clean = None
    on, off = ("default (recorder on)", ()), ("--blackbox off", ("--blackbox", "off"))
    for i, (what, extra) in enumerate((on, off, off, on) * 3):
        rep = run(f"clean{i}", *extra)
        clean = clean or strip(rep)
        check(strip(rep) == clean, f"faults: {what} run {i} differs from the first clean run")
        rates[what].append(rep["totals"]["sustained_lines_per_sec"])
    for what, r in rates.items():
        r = sorted(r)
        say(f"faults: {what}: sustained_lines_per_sec {r} (median {(r[2] + r[3]) / 2:.1f}), "
            f"16x256 text, 2^20 lines, batch 2^18, prefetch 2; runs in turns on {card}")

    plan = "stream.device_put.fail@3:2"
    ring = ("--feed-workers", "2", "--feed-mode", "ring")
    # the ring feeder's batches follow raw-line counts: its own clean run
    clean_ring = strip(run("clean-ring", *ring))
    for what, extra, want in (("synchronous loop", ("--prefetch-depth", "0"), clean),
                              ("prefetch depth 2", ("--prefetch-depth", "2"), clean),
                              ("ring feeder", ring, clean_ring)):
        rep = run(f"put-{what.split()[0]}", "--fault-plan", plan, *extra)
        ctr = retrypolicy.counters().get("device_put")
        check(strip(rep) == want, f"faults: {plan} ({what}) gave another report")
        check(ctr == {"attempts": 2, "recoveries": 1, "giveups": 0},
              f"faults: {plan} ({what}): device_put counters {ctr}")
        say(f"faults: --fault-plan {plan}, {what}: the clean report, device_put {ctr}; "
            f"sustained_lines_per_sec {rep['totals']['sustained_lines_per_sec']} on {card}")

    # exhausted: the typed abort, its postmortem beside the checkpoint dir
    # (the recorder's default home), and doctor's diagnosis of it
    from ruleset_analysis_tpu_torch.ops import first_match

    first_match.first_match_rows.launches = 0
    rc = cli.main(["run", "--ruleset", prefix, "--logs", logs, "--batch-size", str(batch),
                   "--checkpoint-dir", ck, "--fault-plan", "stream.device_put.fail@3:99",
                   "--json", "--out", os.path.join(d, "aborted.json")])
    ctr = retrypolicy.counters().get("device_put")
    pm = os.path.join(bb, "postmortem.json")
    check(rc == 1 and os.path.exists(pm),
          f"faults: device_put@3:99 exited {rc} (want 1), postmortem {os.path.exists(pm)}")
    check(first_match.first_match_rows.launches > 0,
          "faults: the aborted run launched no first_match before its fault")
    diag = os.path.join(d, "doctor.json")
    check(cli.main(["doctor", bb, "--json", "--out", diag]) == 0, "faults: doctor failed")
    with open(diag, encoding="utf-8") as f:
        dj = json.load(f)
    text = json.dumps(dj["diagnosis"])
    check(dj["trigger"] == "abort" and dj["exit_code"] == 1
          and dj["error_type"] == "InjectedFault" and "stream.device_put.fail" in text,
          f"faults: doctor's diagnosis {dj}")
    say(f"faults: --fault-plan stream.device_put.fail@3:99: exit 1, device_put {ctr}, "
        f"{pm} written; doctor: trigger {dj['trigger']}, failing stage "
        f"{dj['failing_stage']}, causes {[x['cause'] for x in dj['diagnosis']]}")
    for f in os.listdir(bb):
        os.remove(os.path.join(bb, f))

    plan = "checkpoint.torn_state@1:1"
    rep = run("torn", "--checkpoint-every", "2", "--fault-plan", plan)
    ctr = retrypolicy.counters().get("checkpoint.save")
    check(strip(rep) == clean and ctr == {"attempts": 1, "recoveries": 1, "giveups": 0},
          f"faults: {plan}: report equal {strip(rep) == clean}, checkpoint.save {ctr}")
    say(f"faults: --checkpoint-every 2 --fault-plan {plan}: the clean report, "
        f"checkpoint.save {ctr}")

    tr = os.path.join(d, "trace")
    rep = run("trace", "--trace-out", tr)
    check(strip(rep) == clean, "faults: --trace-out changed the report")
    with open(os.path.join(tr, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e["name"] for e in events)
    check(TRACE_NAMES <= set(names) <= TRACE_NAMES | TRACE_NAMES_MAY,
          f"faults: trace names {dict(names)}")
    check(names["step.dispatch"] == rep["totals"]["chunks"],
          f"faults: {names['step.dispatch']} step.dispatch spans for "
          f"{rep['totals']['chunks']} chunks")
    say(f"faults: --trace-out: {len(events)} events, names {dict(sorted(names.items()))}; "
        f"sustained_lines_per_sec {rep['totals']['sustained_lines_per_sec']} on {card}")
    return dict(launches)


#: the hand kernels a --profile-dir trace of a 16x256 text run must name:
#: launch counter (cli_run's names) -> the kernel's __global__ name, which
#: CUPTI records demangled, in the .cu's anonymous namespace:
#: "(anonymous namespace)::first_match_kernel(unsigned int const*, ...)"
TRACE_KERNELS = {"first_match": "first_match_kernel", "reg_tail": "reg_tail_kernel",
                 "select": "select_kernel"}


def trace_kernels(path: str) -> dict:
    """{kernel_base name: records} of the CUDA kernel records of a Chrome
    trace that torch.profiler wrote."""
    from collections import Counter

    from ruleset_analysis_tpu_torch.runtime.devprof import kernel_base

    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return dict(Counter(kernel_base(e.get("name", "")) for e in events
                        if e.get("cat") == "kernel"))


def jsonl(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def phase_metrics(work: str, card: str) -> dict:
    """Run telemetry on the card, through the CLI.

    16x256 ruleset, phase_full_width's 2^20 text lines at batch 2^18 (four
    chunks).  ``--metrics-out`` at 0.05 s with ``--report-every 1`` on the
    synchronous loop, at prefetch 2 and through the ring feeder (each the
    clean report; the JSONL's samplers, ``device_mem`` within the card's
    memory, a ``throughput`` event a chunk, the ``final`` snapshot's
    lines); ``--checkpoint-every 2`` (a ``checkpoint`` event a save); an
    exhausted ``stream.device_put.fail@3:99`` (the postmortem's samplers
    and queue depths); ``--profile-dir`` (the trace's kernel records
    against the run's launches).  Then the rate of the default run against
    ``--metrics-out`` at 10 s and 0.05 s and ``--profile-dir``, six runs
    each in turns.
    """
    from collections import Counter

    import torch

    from ruleset_analysis_tpu_torch import cli

    full = os.path.join(work, "full")
    prefix, logs = os.path.join(full, "fw1"), os.path.join(full, "fw1.log")
    d = os.path.join(work, "metrics")
    os.makedirs(d, exist_ok=True)
    ck = os.path.join(d, "ck")
    bb = os.path.join(d, "blackbox")  # the recorder's default: beside the checkpoint dir
    batch = FAULTS_B
    total_mem = torch.cuda.get_device_properties(0).total_memory
    launches = Counter()

    def run(tag: str, *extra: str) -> tuple[dict, dict]:
        rep, n = cli_run(prefix, logs, None, batch, ("--checkpoint-dir", ck, *extra),
                         tag=f"-metrics-{tag}")
        launches.update(n)
        check(rep["totals"]["lines_total"] == FULL_B, f"metrics {tag}: not every line consumed")
        return rep, n

    def fresh(name: str) -> str:
        path = os.path.join(d, name)
        if os.path.exists(path):
            os.remove(path)
        return path

    clean = strip(run("clean")[0])
    ring = ("--feed-workers", "2", "--feed-mode", "ring")
    clean_ring = strip(run("clean-ring", *ring)[0])
    for what, extra, want in (("synchronous loop", ("--prefetch-depth", "0"), clean),
                              ("prefetch depth 2", ("--prefetch-depth", "2"), clean),
                              ("ring feeder", ring, clean_ring)):
        mf = fresh(f"m-{what.split()[0]}.jsonl")
        rep, _ = run(f"jsonl-{what.split()[0]}", "--metrics-out", mf, "--metrics-every", "0.05",
                     "--report-every", "1", *extra)
        check(strip(rep) == want, f"metrics: --metrics-out ({what}) changed the report")
        recs = jsonl(mf)
        kinds = Counter(r["kind"] for r in recs)
        snaps = [r for r in recs if r["kind"] == "snapshot"]
        final = recs[-1]
        # the synchronous loop has no prefetch queue, so no ingest sampler
        need = {"retry", "device_mem"} | ({"ingest"} if what != "synchronous loop" else set())
        need |= {"feeder"} if what == "ring feeder" else set()
        seen = set().union(*(set(r) for r in snaps)) if snaps else set()
        check(snaps and need <= seen,
              f"metrics ({what}): {len(snaps)} snapshots, keys {sorted(seen)}, want {need}")
        for r in snaps:
            g = r["device_mem"]
            used, peak, lim = (g[f"device_mem_{k}"] for k in
                               ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"))
            check(all(type(v) is int for v in (used, peak, lim))
                  and 0 < used <= peak <= lim == total_mem,
                  f"metrics ({what}): device_mem {g} (card total {total_mem})")
        check(kinds["throughput"] == rep["totals"]["chunks"] == 4,
              f"metrics ({what}): {kinds['throughput']} throughput events for "
              f"{rep['totals']['chunks']} chunks")
        check(final["kind"] == "final" and final["lines"] == rep["totals"]["lines_total"],
              f"metrics ({what}): final record {final}")
        used = [r["device_mem"]["device_mem_bytes_in_use"] for r in snaps]
        mem = snaps[-1]["device_mem"]
        say(f"metrics: --metrics-out at 0.05 s, {what}: the clean report; records "
            f"{dict(kinds)}; snapshot keys {sorted(seen)}; device_mem in use "
            f"{min(used)}-{max(used)} B over the snapshots, peak "
            f"{mem['device_mem_peak_bytes_in_use']} B, limit {mem['device_mem_bytes_limit']} "
            f"B; final lines {final['lines']}, final device_mem {final['device_mem']}")

    mf = fresh("m-ckpt.jsonl")
    rep, _ = run("ckpt", "--checkpoint-every", "2", "--metrics-out", mf)
    check(strip(rep) == clean, "metrics: --checkpoint-every 2 changed the report")
    saves = [r for r in jsonl(mf) if r["kind"] == "checkpoint"]
    # a save at chunks 2 and 4, and the end-of-run save
    check([r["n_chunks"] for r in saves] == [2, 4, 4] and all(r["bytes"] > 0 for r in saves),
          f"metrics: checkpoint events {saves}")
    say(f"metrics: --checkpoint-every 2: {len(saves)} checkpoint events, one a save: "
        + ", ".join(f"chunk {r['n_chunks']} {r['bytes']} B {r['save_sec']} s" for r in saves))

    # exhausted: the postmortem carries the gauges read where the run failed
    rc = cli.main(["run", "--ruleset", prefix, "--logs", logs, "--batch-size", str(batch),
                   "--checkpoint-dir", ck, "--fault-plan", "stream.device_put.fail@3:99",
                   "--metrics-out", fresh("m-abort.jsonl"), "--metrics-every", "0.05",
                   "--json", "--out", os.path.join(d, "aborted.json")])
    pm = os.path.join(bb, "postmortem.json")
    check(rc == 1 and os.path.exists(pm),
          f"metrics: device_put@3:99 exited {rc}, postmortem {os.path.exists(pm)}")
    with open(pm, encoding="utf-8") as f:
        bundle = json.load(f)
    (main_shard,) = [s for s in bundle["shards"] if s["role"] == "main"]
    qd = bundle["analysis"]["queue_depths"]
    check({"ingest", "retry", "device_mem"} <= set(main_shard["samplers"]) and qd,
          f"metrics: postmortem samplers {sorted(main_shard['samplers'])}, queue_depths {qd}")
    say(f"metrics: --fault-plan stream.device_put.fail@3:99 with --metrics-out: exit 1, "
        f"postmortem samplers {sorted(main_shard['samplers'])}, queue_depths {qd}")
    for f in os.listdir(bb):
        os.remove(os.path.join(bb, f))

    prof = os.path.join(d, "profile")
    rep, n = run("profile", "--profile-dir", prof)
    check(strip(rep) == clean, "metrics: --profile-dir changed the report")
    (trace,) = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    recs = trace_kernels(trace)
    counts = {k: (n[k], recs.get(g, 0)) for k, g in TRACE_KERNELS.items()}
    for k, (launched, recorded) in counts.items():
        check(launched == 0 or recorded > 0,
              f"metrics: --profile-dir trace holds no {TRACE_KERNELS[k]} record for "
              f"{launched} launches ({recs})")
    short = {k: v for k, v in counts.items() if v[1] < v[0]}
    say(f"metrics: --profile-dir trace {os.path.getsize(trace)} B, kernel records against "
        f"launches (launches, records): {counts}"
        + (f"; SHORTFALL {short}" if short else "; none missing")
        + f"; every kernel record of the trace: {recs}")
    os.remove(trace)

    rates: dict[str, list] = {}
    r10, r005 = os.path.join(d, "r10.jsonl"), os.path.join(d, "r005.jsonl")
    arms = (("default", ()),
            ("--metrics-out, 10 s", ("--metrics-out", r10)),
            ("--metrics-out, 0.05 s", ("--metrics-out", r005, "--metrics-every", "0.05")),
            ("--profile-dir", ("--profile-dir", prof)))
    for i in range(6):
        for what, extra in (arms if i % 2 == 0 else arms[::-1]):
            for p in (r10, r005):
                if os.path.exists(p):
                    os.remove(p)
            rep, _ = run(f"rate{i}", *extra)
            check(strip(rep) == clean, f"metrics: {what} run {i} changed the report")
            rates.setdefault(what, []).append(rep["totals"]["sustained_lines_per_sec"])
            if what.startswith("--metrics-out"):
                snaps = [r for r in jsonl(r10 if "10 s" in what else r005)
                         if r["kind"] == "snapshot"]
                rates.setdefault(f"{what}: snapshots", []).append(len(snaps))
    for what, r in rates.items():
        r = sorted(r)
        say(f"metrics: {what}: " + ("" if what.endswith("snapshots") else
                                    "sustained_lines_per_sec ")
            + f"{r} (median {(r[2] + r[3]) / 2:.1f}), 16x256 text, 2^20 lines, batch 2^18, "
            f"prefetch 2; runs in turns on {card}")
    return dict(launches)


#: the elastic phase: the ingest phase's text corpus cut into four shards
#: of 2^19 lines, at batch 2^16 (8 chunks a shard, 32 in all), an epoch
#: every 8 chunks
ELASTIC_B = 1 << 16
ELASTIC_EVERY = 8
#: the re-formation drill's fault: the copy of chunk 20 fails past its
#: retries (the distributed loop's device_put seam, one hit a chunk: hits
#: 20-24 of 5 attempts), after generation 0's second epoch (chunk 16);
#: generation 1 replays the 16 chunks from that epoch, so it never reaches
#: hit 20
ELASTIC_FAIL_CHUNK = 20
ELASTIC_PLAN = f"stream.device_put.fail@{ELASTIC_FAIL_CHUNK}:99"


def elastic_launcher(prefix: str, d: str, shards: list, *extra: str,
                     plan: str = "") -> tuple[int, float, str, dict | None]:
    """One elastic launcher of the port's CLI (`--num-processes 1
    --process-id 0`) in a process of its own, ``plan`` in its environment:
    its exit code, wall seconds, stderr and report (None without one)."""
    env = dict(os.environ)
    env.pop("RA_FAULT_PLAN", None)
    if plan:
        env["RA_FAULT_PLAN"] = plan
    out = os.path.join(d, "report.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "run", "--ruleset", prefix,
         "--logs", *shards, "--batch-size", str(ELASTIC_B), "--checkpoint-every",
         str(ELASTIC_EVERY), "--checkpoint-dir", os.path.join(d, "ck"), "--distributed",
         "--elastic", "--elastic-dir", os.path.join(d, "eldir"), "--num-processes", "1",
         "--process-id", "0", "--json", "--out", out, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    rep = None
    if os.path.exists(out):
        with open(out, encoding="utf-8") as fh:
            rep = json.load(fh)
    return proc.returncode, wall, proc.stderr, rep


def generation_walls(eldir: str) -> list[float]:
    """Each generation worker's process wall, seconds: from its plan, which
    the supervisor writes just before the spawn, to the last write of its
    rank 0's log (the worker's exit)."""
    walls = []
    g = 0
    while os.path.isdir(os.path.join(eldir, f"gen-{g}")):
        gd = os.path.join(eldir, f"gen-{g}")
        with open(os.path.join(gd, "plan.json"), encoding="utf-8") as fh:
            tag = json.load(fh)["world"][0]
        walls.append(round(os.path.getmtime(os.path.join(gd, f"worker-{tag}.log"))
                           - os.path.getmtime(os.path.join(gd, "plan.json")), 2))
        g += 1
    return walls


def phase_elastic(work: str, card: str, ing: dict, el: dict) -> dict:
    """`run --distributed --elastic` on the card: one member over a one-rank
    NCCL group (two ranks may not share the one H100), each launcher a
    process of its own, over the ingest phase's corpus in four shards.

    1. clean: the report is the plain `run`'s over the same shards (but
       VOLATILE_TOTALS, backend, processes, elastic_epoch, recovery), the
       registers (``result.npz``) an uninterrupted run's, no re-formation;
    2. re-formation: ``ELASTIC_PLAN`` fails generation 0 after its second
       epoch; generation 1 resumes from that epoch to the plain run's hits,
       unused set and totals and the uninterrupted registers;
    3. budget: the same plan with ``--max-reforms 0`` exits 7 with no
       report; the postmortem holds the supervisor and the worker, and
       ``doctor`` names the re-formation budget.

    The generation workers are processes the supervisor spawns, so their
    launches are not in the kernels line's counts; that they ran on the
    card shows in their reports (``torch-cuda``; a cuda job never falls
    back to gloo on the CPU).  The launches returned are the plain run's.
    ``el`` gets the shards, the plain report and the uninterrupted
    registers, which the autoscale phase reuses.
    """
    import re
    import shutil

    import numpy as np

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import pack
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    d = os.path.join(work, "elastic")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(ing["logs"], "rb") as fh:
        lines = fh.readlines()
    q = len(lines) // 4
    check(q * 4 == len(lines) and q % ELASTIC_B == 0,
          f"elastic: {len(lines)} lines do not cut into four shards of whole batches")
    shards = []
    for i in range(4):
        shards.append(os.path.join(d, f"shard{i}.log"))
        with open(shards[-1], "wb") as fh:
            fh.writelines(lines[i * q:(i + 1) * q])
    del lines
    prefix = ing["prefix"]
    plain, launches = cli_run(prefix, shards, None, ELASTIC_B, tag="-elastic-plain")
    _, regs = run_stream_file(pack.load_packed(prefix), shards,
                              AnalysisConfig(batch_size=ELASTIC_B), return_state=True)
    el.update(shards=shards, plain=plain, regs=regs)
    pt = plain["totals"]

    def registers_equal(eldir: str, what: str) -> None:
        got = np.load(os.path.join(eldir, "result.npz"))
        for k, v in regs.items():
            check(np.array_equal(got[k], v), f"elastic {what}: result.npz {k} differs from "
                  "the uninterrupted run's registers")

    def drill(name: str, *extra: str, plan: str = ""):
        dd = os.path.join(d, name)
        rc, wall, err, rep = elastic_launcher(prefix, dd, shards, *extra, plan=plan)
        return rc, wall, err, rep, os.path.join(dd, "eldir")

    # 1. clean
    rc, wall1, err, clean, eldir = drill("clean")
    check(rc == 0 and clean is not None, f"elastic clean drill exited {rc}: {err[-3000:]}")
    t1 = clean["totals"]
    check(t1["backend"] == "torch-cuda" and t1["processes"] == 1,
          f"elastic clean drill: backend {t1['backend']}, processes {t1['processes']}")
    check(t1["elastic_epoch"] == 0 and t1["recovery"]["reforms_used"] == 0,
          f"elastic clean drill: epoch {t1['elastic_epoch']}, recovery {t1['recovery']}")
    a, b = strip(clean), strip(plain)
    for r in (a, b):
        for k in ("backend", "processes", "elastic_epoch", "recovery"):
            r["totals"].pop(k, None)
    check(a == b, "elastic clean drill: the report differs from the plain run's")
    registers_equal(eldir, "clean drill")
    say(f"elastic: clean drill, one member (one-rank NCCL group), 16x256, 4 shards x {q} "
        f"lines, batch {ELASTIC_B}, --checkpoint-every {ELASTIC_EVERY}: report == the plain "
        f"run's (but VOLATILE_TOTALS, backend, processes, elastic_epoch, recovery), "
        f"result.npz == the uninterrupted registers; {t1['chunks']} chunks; "
        f"sustained_lines_per_sec {t1['sustained_lines_per_sec']} (plain run in this process "
        f"{pt['sustained_lines_per_sec']}), compile_sec {t1['compile_sec']}; generation walls "
        f"{generation_walls(eldir)} s, launcher wall {wall1:.1f} s; on {card}")

    # 2. a generation fails after its second epoch and the member re-forms
    rc, wall2, err, rep, eldir = drill("reform", plan=ELASTIC_PLAN)
    check(rc == 0 and rep is not None, f"elastic re-formation drill exited {rc}: {err[-3000:]}")
    t2 = rep["totals"]
    rec = t2["recovery"]
    check(t2["backend"] == "torch-cuda", f"elastic re-formation drill: backend {t2['backend']}")
    check(t2["elastic_epoch"] == 1 and rec["reforms_used"] == 1
          and rec.get("recovery_events") == 1,
          f"elastic re-formation drill: epoch {t2['elastic_epoch']}, recovery {rec}")
    check(report_hits(rep) == report_hits(plain) and rep["unused"] == plain["unused"]
          and all(t2[k] == pt[k] for k in ("lines_total", "lines_matched", "lines_skipped")),
          "elastic re-formation drill: hits, unused or line totals differ from the plain run's")
    registers_equal(eldir, "re-formation drill")
    with open(os.path.join(eldir, "gen-1", "worker-0.log"), encoding="utf-8") as fh:
        m = re.search(r"starts at epoch chunk (\d+)", fh.read())
    epoch_chunk = int(m.group(1)) if m else -1
    walls = generation_walls(eldir)
    check(epoch_chunk == 2 * ELASTIC_EVERY,
          f"elastic re-formation drill: generation 1 started at epoch chunk {epoch_chunk}")
    say(f"elastic: re-formation drill (RA_FAULT_PLAN={ELASTIC_PLAN}): generation 0 failed "
        f"typed on chunk {ELASTIC_FAIL_CHUNK} after its epoch at chunk {epoch_chunk}; the "
        f"member re-formed: "
        f"time_to_recover_sec {rec['recoveries'][0]['time_to_recover_sec']}; generation "
        f"walls {walls} s; generation 1 replayed {t2['chunks'] - epoch_chunk} "
        f"chunks from the epoch (chunks {epoch_chunk + 1}-{ELASTIC_FAIL_CHUNK - 1} of "
        f"generation 0 were lost); hits, "
        f"unused, line totals == the plain run's, result.npz == the uninterrupted registers; "
        f"generation 1 sustained_lines_per_sec {t2['sustained_lines_per_sec']} (clean drill "
        f"{t1['sustained_lines_per_sec']}), compile_sec {t2['compile_sec']}, start cost (its "
        f"wall less its loop's elapsed_sec) {walls[-1] - t2['elapsed_sec']:.2f} s; launcher "
        f"wall {wall2:.1f} s; on {card}")

    # 3. the same plan with no re-formation budget
    rc, wall3, err, rep, eldir = drill("budget", "--max-reforms", "0", plan=ELASTIC_PLAN)
    check(rc == 7 and rep is None and not os.path.exists(os.path.join(eldir, "result.json")),
          f"elastic budget drill exited {rc} (want 7), report {rep is not None}: {err[-3000:]}")
    check("budget exhausted" in err, f"elastic budget drill: stderr {err[-2000:]}")
    bb = os.path.join(d, "budget", "blackbox")  # beside --checkpoint-dir
    with open(os.path.join(bb, "postmortem.json"), encoding="utf-8") as fh:
        roles = sorted(s["role"] for s in json.load(fh)["shards"])
    check(roles == ["elastic-supervisor", "elastic-worker-0-gen0"],
          f"elastic budget drill: postmortem roles {roles}")
    diag = os.path.join(d, "budget", "doctor.json")
    check(cli.main(["doctor", bb, "--json", "--out", diag]) == 0, "elastic: doctor failed")
    with open(diag, encoding="utf-8") as fh:
        dj = json.load(fh)
    causes = [x["cause"] for x in dj["diagnosis"]]
    check(dj["exit_code"] == 7
          and "elastic re-formation budget exhausted (--max-reforms)" in causes,
          f"elastic budget drill: doctor's diagnosis {dj}")
    say(f"elastic: budget drill (--max-reforms 0, the same plan): exit 7, no report; "
        f"postmortem roles {roles}; doctor: {causes}; generation walls "
        f"{generation_walls(eldir)} s, launcher wall {wall3:.1f} s; on {card}")
    return launches


#: the autoscale phase's backfill drill: launcher 0's worker dies after this
#: many source batches, past the first epoch (chunk 8) and before the last
#: chunk (32); the prefetch producer runs two batches ahead, so generation 0
#: has saved its epoch at chunk 16
AUTOSCALE_DIE_AFTER = 20
#: the autoscale phase's long observe-only drill reads the elastic shards this
#: many times over (2^25 lines, several of the policy's 3 s sustain windows)
AUTOSCALE_REPEAT = 16


def autoscale_launchers(prefix: str, d: str, shards: list, *extra: str,
                        env_extra: dict | None = None) -> tuple[list[dict], str]:
    """Two autoscaled elastic launchers of the port's CLI, each a process of
    its own, over a pool of two from world 1 (``--autoscale-min 1
    --autoscale-max 2 --autoscale-initial 1``): tag 0 active on the card, tag
    1 parked as a warm standby.  For each: its exit code, the wall-clock time
    it exited, its stderr and its report (None without one)."""
    env = dict(os.environ)
    for k in ("RA_FAULT_PLAN", "RA_ELASTIC_FAULT"):
        env.pop(k, None)
    env.update(env_extra or {})
    eldir = os.path.join(d, "eldir")
    procs = []
    for tag in (0, 1):
        errf = open(os.path.join(d, f"launcher{tag}.err"), "w", encoding="utf-8")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "run", "--ruleset", prefix,
             "--logs", *shards, "--batch-size", str(ELASTIC_B), "--checkpoint-every",
             str(ELASTIC_EVERY), "--checkpoint-dir", os.path.join(d, f"ck{tag}"),
             "--blackbox-dir", os.path.join(d, f"blackbox{tag}"), "--distributed", "--elastic",
             "--elastic-dir", eldir, "--num-processes", "2", "--process-id", str(tag),
             "--autoscale", "--autoscale-min", "1", "--autoscale-max", "2",
             "--autoscale-initial", "1", *extra, "--json", "--out",
             os.path.join(d, f"report{tag}.json")],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=errf), errf))
    ends: list[float | None] = [None, None]
    deadline = time.monotonic() + 600
    while None in ends and time.monotonic() < deadline:
        for i, (p, _f) in enumerate(procs):
            if ends[i] is None and p.poll() is not None:
                ends[i] = time.time()
        time.sleep(0.05)
    out = []
    for tag, ((p, errf), end) in enumerate(zip(procs, ends)):
        if end is None:
            p.kill()
            p.wait()
        errf.close()
        with open(os.path.join(d, f"launcher{tag}.err"), encoding="utf-8") as fh:
            err = fh.read()
        path = os.path.join(d, f"report{tag}.json")
        rep = None
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                rep = json.load(fh)
        out.append({"rc": p.returncode if end is not None else None, "end": end, "err": err,
                    "report": rep})
    return out, eldir


def autoscale_series(path: str, stride: float) -> tuple[list, int, int]:
    """The (t, pressure, starvation) samples the leader's controller derives
    from a metrics shard (``autoscale.ingest_signals`` over snapshots at
    least ``stride`` seconds apart, ``t`` the later snapshot's), the shard's
    snapshot count and how many of them carry the ingest gauges."""
    from ruleset_analysis_tpu_torch.runtime.autoscale import ingest_signals

    recs = [r for r in jsonl(path) if r.get("kind") in ("snapshot", "final")]
    prev, series = None, []
    for rec in recs:
        if prev is not None and float(rec.get("t", 0)) - float(prev.get("t", 0)) < stride:
            continue
        sig = ingest_signals(prev, rec)
        prev = rec
        if sig is not None:
            series.append((float(rec["t"]), round(sig[0], 4), round(sig[1], 4)))
    gauged = sum(1 for r in recs if {"backpressure_sec", "starved_sec"}
                 <= set(r.get("ingest") or {}))
    return series, len(recs), gauged


def sustained_peaks(series: list, sustain: float) -> tuple[int, float, float]:
    """Over the windows the policy engine judges (the samples of the last
    ``1.5 * sustain`` seconds, once they span ``sustain``): how many there
    were, and the highest window minimum of pressure and of starvation, the
    numbers the engine holds to its out and in thresholds."""
    n, top_p, top_s = 0, 0.0, 0.0
    for i, (t, _p, _s) in enumerate(series):
        win = [x for x in series[:i + 1] if t - x[0] <= 1.5 * sustain]
        if t - win[0][0] >= sustain:
            n += 1
            top_p = max(top_p, min(x[1] for x in win))
            top_s = max(top_s, min(x[2] for x in win))
    return n, top_p, top_s


def phase_autoscale(work: str, card: str, ing: dict, el: dict) -> dict:
    """`run --distributed --elastic --autoscale` on the card, over the
    elastic phase's four shards at its batch and cadence, two launchers a
    drill (tag 0 active, tag 1 a warm standby: two ranks never share the one
    H100, so both drills keep the world at 1 and the budget at 0, and an
    acted-on scale event, which needs a world of two, runs only on the CPU
    in tests/test_torch_autoscale_procs.py):

    1. observe-only, scripted (``--autoscale-budget 0 --autoscale-plan
       out@1``): both launchers exit 0; ``totals.autoscale`` counts one
       scale-out, no scale event, final world 1; ``scale-log.jsonl`` holds
       the decision with ``actuate: false``; the report is the plain
       `run`'s (but VOLATILE_TOTALS and the elastic phase's keys) and
       ``result.npz`` the uninterrupted registers; the pressure and
       starvation series the controller read from ``gen-0/metrics-0.jsonl``
       are printed;
    1b. observe-only at the default thresholds (``--autoscale-budget 0``,
       no plan) over the shards ``AUTOSCALE_REPEAT`` times over, a stream
       long enough for the engine to judge several sustain windows: both
       launchers exit 0, no scale event, final world 1, every logged
       decision ``actuate: false``; hits and line totals are the plain
       run's ``AUTOSCALE_REPEAT`` times over, the unused set the plain
       run's; the signal series, the windows the engine judged, their
       highest pressure and starvation minima and its decisions are
       printed;
    2. warm-standby backfill: launcher 0's worker dies after
       ``AUTOSCALE_DIE_AFTER`` batches (``RA_ELASTIC_FAULT``), launcher 0
       exits ``DIE_RC``; tag 1 leaves its park, forms generation 1 alone on
       the card and resumes from the epoch to the plain run's hits, unused
       set and line totals and the uninterrupted registers; the time from
       the death to generation 1's plan and generation 1's wall are printed;
    3. `run --autoscale` without ``--elastic`` exits 2.

    The generation workers are processes of their own, so their launches
    are not in the kernels line's counts (their reports say
    ``torch-cuda``).
    """
    import re
    import shutil

    import numpy as np

    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.runtime.autoscale import read_decision_log
    from ruleset_analysis_tpu_torch.runtime.elastic import DIE_RC

    d = os.path.join(work, "autoscale")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shards, plain, regs = el["shards"], el["plain"], el["regs"]
    pt = plain["totals"]
    prefix = ing["prefix"]

    def registers_equal(eldir: str, what: str) -> None:
        got = np.load(os.path.join(eldir, "result.npz"))
        for k, v in regs.items():
            check(np.array_equal(got[k], v), f"autoscale {what}: result.npz {k} differs from "
                  "the uninterrupted run's registers")

    def plan_of(eldir: str, gen: int) -> dict:
        with open(os.path.join(eldir, f"gen-{gen}", "plan.json"), encoding="utf-8") as fh:
            return json.load(fh)

    # 1. observe-only, scripted
    dd = os.path.join(d, "observe")
    os.makedirs(dd)
    t0 = time.perf_counter()
    runs, eldir = autoscale_launchers(prefix, dd, shards, "--autoscale-budget", "0",
                                      "--autoscale-plan", "out@1", "--autoscale-poll", "0.1")
    wall1 = time.perf_counter() - t0
    check(all(r["rc"] == 0 for r in runs),
          "autoscale observe-only drill: launcher exits "
          f"{[r['rc'] for r in runs]}: {runs[0]['err'][-2000:]} {runs[1]['err'][-2000:]}")
    rep = runs[0]["report"]
    check(rep is not None and runs[1]["report"] is None,
          "autoscale observe-only drill: the report is not launcher 0's alone")
    t1 = rep["totals"]
    a = t1["autoscale"]
    check(t1["backend"] == "torch-cuda" and t1["processes"] == 1,
          f"autoscale observe-only drill: backend {t1['backend']}, processes {t1['processes']}")
    check((a["scale_out"], a["scale_in"], a["scale_events"], a["final_world"]) == (1, 0, 0, 1),
          f"autoscale observe-only drill: totals.autoscale {a}")
    log = read_decision_log(os.path.join(eldir, "scale-log.jsonl"))
    check(len(log) == 1 and (log[0]["direction"], log[0]["reason"], log[0]["actuate"],
                             log[0]["from_world"], log[0]["to_world"])
          == ("out", "plan", False, 1, 2),
          f"autoscale observe-only drill: scale-log.jsonl {log}")
    p0 = plan_of(eldir, 0)
    check((p0["world"], p0["standby"]) == ([0], [1])
          and not os.path.exists(os.path.join(eldir, "gen-1"))
          and not os.path.exists(os.path.join(eldir, "scale.json")),
          f"autoscale observe-only drill: plan {p0}, or a second generation")
    x, y = strip(rep), strip(plain)
    for r in (x, y):
        for k in ("backend", "processes", "elastic_epoch", "recovery"):
            r["totals"].pop(k, None)
    check(x == y, "autoscale observe-only drill: the report differs from the plain run's")
    registers_equal(eldir, "observe-only drill")
    shard = os.path.join(eldir, "gen-0", "metrics-0.jsonl")
    series, n_snap, gauged = autoscale_series(shard, 1.0)
    series = [(p, s) for _t, p, s in series]
    fine = [(p, s) for _t, p, s in autoscale_series(shard, 0.0)[0]]
    check(series and gauged, f"autoscale observe-only drill: {n_snap} snapshots, {gauged} with "
          f"the ingest gauges, {len(series)} signal samples")
    say(f"autoscale: observe-only drill (two launchers, pool 2 from world 1, --autoscale-budget "
        f"0 --autoscale-plan out@1 --autoscale-poll 0.1), 16x256, 4 shards, batch {ELASTIC_B}, "
        f"--checkpoint-every {ELASTIC_EVERY}: both exit 0; decision {log[0]['direction']} "
        f"{log[0]['from_world']}->{log[0]['to_world']} ({log[0]['reason']}, actuate "
        f"{log[0]['actuate']}) logged, totals.autoscale scale_out {a['scale_out']} "
        f"scale_events {a['scale_events']} final_world {a['final_world']}; report == the plain "
        f"run's (but VOLATILE_TOTALS, backend, processes, elastic_epoch, recovery), result.npz "
        f"== the uninterrupted registers; {t1['chunks']} chunks; sustained_lines_per_sec "
        f"{t1['sustained_lines_per_sec']}; generation walls {generation_walls(eldir)} s, "
        f"launcher wall {wall1:.1f} s; on {card}")
    say(f"autoscale: signals of gen-0/metrics-0.jsonl (snapshots every 0.1 s, {n_snap} of them, "
        f"{gauged} with the ingest gauges; ingest_signals over a >= 1 s stride, as the "
        f"controller reads them): (pressure, starvation) = {series}; between consecutive "
        f"snapshots: {fine}; on {card}")

    # 1b. observe-only at the default thresholds over a long stream
    from ruleset_analysis_tpu_torch.config import AutoscaleConfig

    acfg = AutoscaleConfig()
    dd = os.path.join(d, "observe-long")
    os.makedirs(dd)
    runs, eldir = autoscale_launchers(prefix, dd, shards * AUTOSCALE_REPEAT,
                                      "--autoscale-budget", "0")
    check(all(r["rc"] == 0 for r in runs),
          "autoscale long observe-only drill: launcher exits "
          f"{[r['rc'] for r in runs]}: {runs[0]['err'][-2000:]} {runs[1]['err'][-2000:]}")
    rep = runs[0]["report"]
    check(rep is not None and runs[1]["report"] is None,
          "autoscale long observe-only drill: the report is not launcher 0's alone")
    t3 = rep["totals"]
    a = t3["autoscale"]
    log = read_decision_log(os.path.join(eldir, "scale-log.jsonl"))
    check(t3["backend"] == "torch-cuda" and a["scale_events"] == 0 and a["final_world"] == 1
          and all(x.get("actuate") is False for x in log)
          and not os.path.exists(os.path.join(eldir, "gen-1"))
          and not os.path.exists(os.path.join(eldir, "scale.json")),
          f"autoscale long observe-only drill: backend {t3['backend']}, totals.autoscale {a}, "
          f"scale-log.jsonl {log}, or a second generation")
    check(report_hits(rep) == {k: AUTOSCALE_REPEAT * v for k, v in report_hits(plain).items()}
          and rep["unused"] == plain["unused"]
          and all(t3[k] == AUTOSCALE_REPEAT * pt[k]
                  for k in ("lines_total", "lines_matched", "lines_skipped")),
          f"autoscale long observe-only drill: hits, unused or line totals differ from the "
          f"plain run's {AUTOSCALE_REPEAT} times over")
    timed, n_snap, gauged = autoscale_series(os.path.join(eldir, "gen-0", "metrics-0.jsonl"),
                                             1.0)
    n_win, top_p, top_s = sustained_peaks(timed, acfg.sustain_sec)
    check(n_win >= 3 and gauged,
          f"autoscale long observe-only drill: {n_snap} snapshots, {gauged} with the ingest "
          f"gauges, {len(timed)} signal samples, {n_win} sustain windows (want >= 3)")
    say(f"autoscale: long observe-only drill (two launchers, pool 2 from world 1, "
        f"--autoscale-budget 0, default policy: poll {acfg.poll_sec} s, sustain "
        f"{acfg.sustain_sec} s, out >= {acfg.out_threshold}, in >= {acfg.in_threshold}, "
        f"cooldown {acfg.cooldown_sec} s), the 4 shards {AUTOSCALE_REPEAT} times over, "
        f"{t3['lines_total']} lines, batch {ELASTIC_B}: both exit 0; hits and line totals the "
        f"plain run's x{AUTOSCALE_REPEAT}, unused the plain run's; {t3['chunks']} chunks; "
        f"sustained_lines_per_sec {t3['sustained_lines_per_sec']}; generation wall "
        f"{generation_walls(eldir)} s; on {card}")
    say(f"autoscale: long drill signals ({n_snap} snapshots, {gauged} with the ingest gauges; "
        f">= 1 s strides, t from the first): (t, pressure, starvation) = "
        f"{[(round(t - timed[0][0], 2), p, s) for t, p, s in timed]}; {n_win} sustain windows "
        f"judged, highest window minimum: pressure {top_p} (out at {acfg.out_threshold}), "
        f"starvation {top_s} (in at {acfg.in_threshold}); observe-only decisions "
        f"{[(x['direction'], x['reason'], x['from_world'], x['to_world']) for x in log]}; "
        f"on {card}")

    # 2. warm-standby backfill
    dd = os.path.join(d, "backfill")
    os.makedirs(dd)
    t0 = time.perf_counter()
    runs, eldir = autoscale_launchers(
        prefix, dd, shards, "--autoscale-budget", "0",
        env_extra={"RA_ELASTIC_FAULT": f"tag=0,after_batches={AUTOSCALE_DIE_AFTER}"})
    wall2 = time.perf_counter() - t0
    check(runs[0]["rc"] == DIE_RC and runs[1]["rc"] == 0,
          f"autoscale backfill drill: launcher exits {[r['rc'] for r in runs]} (want "
          f"[{DIE_RC}, 0]): {runs[1]['err'][-3000:]}")
    rep = runs[1]["report"]
    check(rep is not None and runs[0]["report"] is None,
          "autoscale backfill drill: the report is not launcher 1's alone")
    t2 = rep["totals"]
    check(t2["backend"] == "torch-cuda" and t2["processes"] == 1 and t2["elastic_epoch"] == 1,
          f"autoscale backfill drill: backend {t2['backend']}, processes {t2['processes']}, "
          f"epoch {t2['elastic_epoch']}")
    p1 = plan_of(eldir, 1)
    check((plan_of(eldir, 0)["world"], p1["world"], p1["standby"]) == ([0], [1], []),
          f"autoscale backfill drill: plans {plan_of(eldir, 0)}, {p1}")
    with open(os.path.join(eldir, "gen-1", "worker-1.log"), encoding="utf-8") as fh:
        m = re.search(r"starts at epoch chunk (\d+)", fh.read())
    epoch_chunk = int(m.group(1)) if m else -1
    check(ELASTIC_EVERY <= epoch_chunk < t2["chunks"],
          f"autoscale backfill drill: generation 1 started at epoch chunk {epoch_chunk}")
    check(report_hits(rep) == report_hits(plain) and rep["unused"] == plain["unused"]
          and all(t2[k] == pt[k] for k in ("lines_total", "lines_matched", "lines_skipped")),
          "autoscale backfill drill: hits, unused or line totals differ from the plain run's")
    registers_equal(eldir, "backfill drill")
    a = t2["autoscale"]
    check(a["scale_events"] == 0 and a["final_world"] == 1,
          f"autoscale backfill drill: totals.autoscale {a}")
    to_plan = os.path.getmtime(os.path.join(eldir, "gen-1", "plan.json")) - runs[0]["end"]
    walls = generation_walls(eldir)
    say(f"autoscale: warm-standby backfill drill (RA_ELASTIC_FAULT=tag=0,after_batches="
        f"{AUTOSCALE_DIE_AFTER}, --autoscale-budget 0): launcher 0 exited {runs[0]['rc']}; "
        f"standby 1 formed generation 1 alone {to_plan:.2f} s after launcher 0's exit "
        f"(its heartbeat goes stale after 7.5 s) and resumed from the epoch at chunk "
        f"{epoch_chunk}; hits, unused, line totals == the plain run's, result.npz == the "
        f"uninterrupted registers; generation walls {walls} s (generation 1's {walls[-1]} s), "
        f"generation 1 sustained_lines_per_sec {t2['sustained_lines_per_sec']}; observe-only "
        f"decisions {[(x['direction'], x['reason']) for x in a['decisions']]}; launcher wall "
        f"{wall2:.1f} s; on {card}")

    # 3. --autoscale without --elastic
    rc = cli.main(["run", "--ruleset", prefix, "--logs", shards[0], "--autoscale", "--json"])
    check(rc == 2, f"autoscale: `run --autoscale` without --elastic exited {rc} (want 2)")
    say("autoscale: `run --autoscale` without --elastic exits 2")
    return {}


#: the devprof phase's batch (the ingest corpus in 32 chunks) and window
DEVPROF_B = 1 << 16
DEVPROF_STEPS = 16
DEVPROF_WARMUP = 3


def capture_batch_kernel_ms(dev, batch: int) -> dict:
    """ms a launch of each step kernel by CUDA events (device_ms) at the
    capture runs' batch: the 16x256 ruleset's default step (first_match,
    reg_tail on the scan route, the select), its fused match (match_hist),
    and the dual-stack ruleset's v6 match (first_match6)."""
    import numpy as np
    import torch

    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.hostside import pack, synth
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops import first_match, first_match6, match_hist, reg_tail, topk

    cfg = AnalysisConfig(batch_size=batch)
    sk = cfg.sketch
    _, packed = ruleset(*SHAPES[1])
    r = pipeline.ship_ruleset(packed, dev)
    t = np.ascontiguousarray(synth.synth_tuples(packed, batch, seed=3).T)
    batch_t = torch.from_numpy(pack.compact_batch(t).view(np.int32)).to(dev)
    cols, valid = pipeline.batch_cols(batch_t)
    fields = [cols[k] for k in first_match.FIELDS]
    st = pipeline.init_state(packed.n_keys, cfg, dev)
    row = first_match.first_match_rows(fields, r.rules_k, r.acl_span)

    def tail():
        return reg_tail.reg_tail(st.talk_cms, st.hll, row, valid, cols["acl"], (cols["src"],),
                                 r.key_k, n_rows=r.rules_k.shape[0], counts=True, salt=5,
                                 sample_shift=sk.topk_sample_shift)

    _, cnt, rep = tail()
    k = topk.cand_k(sk.topk_chunk_candidates, batch, sk.topk_sample_shift)
    _, packed6 = ruleset(*SHAPES[1], v6_fraction=V6_FRACTION)
    r6 = pipeline.ship_ruleset6(packed6, dev)
    t6 = np.ascontiguousarray(synth.synth_tuples6(packed6, batch, seed=4).T)
    c6, _ = pipeline.batch_cols6(torch.from_numpy(pack.compact_batch6(t6).view(np.int32)).to(dev))
    f6 = [c6[k] for k in first_match6.FIELDS6]
    calls = {
        "first_match_kernel": lambda: first_match.first_match_rows(fields, r.rules_k, r.acl_span),
        "match_hist_kernel": lambda: match_hist.match_rows_and_hists(
            fields, valid, r.rules_k, r.acl_span, packed.n_acls),
        "reg_tail_kernel": tail,
        "select_kernel": lambda: reg_tail.select_tables(
            cnt, rep, cols["acl"], (cols["src"],), st.talk_cms, k, salt=5,
            sample_shift=sk.topk_sample_shift),
        "first_match6_kernel": lambda: first_match6.first_match_rows6(f6, r6.rules_k6,
                                                                      r6.acl_span6),
    }
    return {name: sorted(device_ms(fn, 20) for _ in range(3))[1] for name, fn in calls.items()}


def capture_kernels(dp: dict) -> dict:
    """{hand kernel: (records, profiler us a record)} of a capture's trace,
    each record in a program range; every one must lie in its kernel's
    primary stage (stages.KERNEL_STAGES)."""
    from ruleset_analysis_tpu_torch.runtime import devprof

    with open(dp["trace_path"], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    recs = [r for r in devprof.attribute_events(events, programs=set(dp["programs"]))
            if r["kernel"] is not None and r["program"] is not None]
    for r in recs:
        check(r["stage"] == devprof.KERNEL_STAGES[r["kernel"]][0],
              f"devprof: {r['kernel']} attributed to {r['stage']} in {r['program']} "
              f"(via {r['via']})")
    out = {}
    for r in recs:
        n, us = out.get(r["kernel"], (0, 0.0))
        out[r["kernel"]] = (n + 1, us + r["dur"])
    return {k: (n, us / n) for k, (n, us) in sorted(out.items())}


def phase_devprof(work: str, dev, card: str, ing: dict, dual: dict, kernel_ms: dict) -> dict:
    """`run --devprof-out` on the card, through the CLI: the ingest phase's
    2^21 16x256 text lines at batch 2^16 (32 chunks) under the default scan,
    `--match-impl fused` and `--layout stacked`, and the dual-stack 16x256
    2^20-line corpus (step.flat and step.v6), each with `--devprof-steps 16
    --devprof-warmup 3`.  Each armed report equals its disarmed run's but
    for VOLATILE_TOTALS; at least 0.9 of the window's device time is
    attributed to a stage; every hand kernel record lies in its
    KERNEL_STAGES primary stage; each hand kernel's records against its
    launches are printed (a shortfall, `records_short`, is printed, not
    failed: the card's known behaviour), and so are each stage's device us a
    step and each kernel's profiler us a record beside its CUDA-event time
    at this batch and the kernel phases' (B = 2^20).  Then the default
    run's rate armed against disarmed, six runs each in turns, and the
    one-device `run --distributed --devprof-out` refusal (exit 2)."""
    from collections import Counter

    from ruleset_analysis_tpu_torch import cli

    d = os.path.join(work, "devprof")
    os.makedirs(d, exist_ok=True)
    launches = Counter()
    b = DEVPROF_B
    at_batch = capture_batch_kernel_ms(dev, b)

    def run(prefix, logs, impl, extra, tag, out_dir=None):
        armed = () if out_dir is None else (
            "--devprof-out", out_dir, "--devprof-steps", str(DEVPROF_STEPS),
            "--devprof-warmup", str(DEVPROF_WARMUP))
        if out_dir is not None and os.path.exists(os.path.join(out_dir, "devprof.json")):
            os.remove(os.path.join(out_dir, "devprof.json"))
        t0 = time.perf_counter()
        rep, n = cli_run(prefix, logs, impl, b, (*extra, *armed), tag=f"-dp-{tag}")
        wall = time.perf_counter() - t0
        launches.update(n)
        return rep, n, wall

    def check_capture(what: str, rep: dict, n: dict, out_dir: str, programs: set,
                      steps: int) -> dict:
        dp = rep["totals"].get("devprof")
        check(dp is not None and "error" not in dp, f"devprof {what}: no capture ({dp})")
        with open(os.path.join(out_dir, "devprof.json"), encoding="utf-8") as f:
            check(json.load(f) == dp, f"devprof {what}: devprof.json != totals.devprof")
        check(dp["backend"] == "cuda" and set(dp["programs"]) == programs,
              f"devprof {what}: backend {dp['backend']}, programs {sorted(dp['programs'])}")
        check(dp["steps_profiled"] == steps,
              f"devprof {what}: {dp['steps_profiled']} steps profiled, want {steps}")
        check(dp["attributed_frac"] >= 0.9,
              f"devprof {what}: attributed_frac {dp['attributed_frac']} < 0.9")
        kr = dp["kernel_records"]
        for name in ("first_match", "match_hist", "first_match6", "reg_tail", "select"):
            check(f"{name}_kernel" in kr, f"devprof {what}: no kernel_records for {name}")
        kept = capture_kernels(dp)
        ran = {k for k, v in kr.items() if v["launches"]}
        check(bool(ran), f"devprof {what}: no hand kernel launched in the window")
        steps_n = dp["steps_profiled"]
        say(f"devprof {what}: {steps_n} steps profiled, window_wall_sec "
            f"{dp['window_wall_sec']}, attributed_frac {dp['attributed_frac']}, "
            f"device_us_total {dp['device_us_total']} ({dp['device_us_total'] / steps_n:.1f} us "
            f"a step), programs " + ", ".join(
                f"{k} {v['dispatches']} dispatches x {v['device_ops']} device ops"
                for k, v in dp["programs"].items())
            + f", cross-stage kernels {[c['name'] for c in dp['cross_stage_fusions']]}; on {card}")
        say(f"devprof {what}: device us a step by stage: " + ", ".join(
            f"{s} {v['device_us'] / steps_n:.1f} ({v['pct']}%, {v['events']} events)"
            for s, v in dp["stages"].items())
            + f", unattributed {dp['unattributed']['device_us'] / steps_n:.1f}")
        say(f"devprof {what}: records against launches (launches, records): "
            + ", ".join(f"{k} ({v['launches']}, {v['records']})" for k, v in kr.items())
            + f"; records_short {dp['records_short']}"
            + (f"; launched with no record in the trace: {sorted(ran - set(kept))}"
               if ran - set(kept) else ""))
        for k, (recs, us) in kept.items():
            phase = kernel_ms.get(k)
            say(f"devprof {what}: {k}: {recs} records, profiler {us:.1f} us a record; CUDA "
                f"events a call of its wrapper at batch {b} (its fills included): "
                f"{at_batch[k] * 1e3:.1f} us"
                + (f"; the kernel phases' (B = {FULL_B}): {phase * 1e3:.1f} us" if phase
                   else ""))
        return dp

    runs = {
        "default": (ing["prefix"], ing["logs"], None, (), {"step.flat"}, DEVPROF_STEPS),
        "fused": (ing["prefix"], ing["logs"], "fused", (), {"step.flat"}, DEVPROF_STEPS),
        "stacked": (ing["prefix"], ing["logs"], None, ("--layout", "stacked"),
                    {"step.stacked"}, DEVPROF_STEPS),
        "dual-stack": (dual["prefix"], dual["big"], None, (), {"step.flat", "step.v6"}, None),
    }
    summaries = {}
    for what, (prefix, logs, impl, extra, programs, steps) in runs.items():
        plain, _, _ = run(prefix, logs, impl, extra, f"{what}-plain")
        out_dir = os.path.join(d, what)
        rep, n, _ = run(prefix, logs, impl, extra, what, out_dir)
        check(strip(rep) == strip(plain), f"devprof {what}: the armed report != the disarmed one")
        if steps is None:  # the window ends with the stream
            steps = min(DEVPROF_STEPS, rep["totals"]["chunks"] - DEVPROF_WARMUP)
        summaries[what] = check_capture(what, rep, n, out_dir, programs, steps)

    # the default run's rate, disarmed and armed, in turns
    rates: dict = {"disarmed": [], "armed": []}
    walls: dict = {"disarmed": [], "armed": []}
    windows = []
    base = None
    for i in range(6):
        for arm in (("disarmed", "armed") if i % 2 == 0 else ("armed", "disarmed")):
            out_dir = os.path.join(d, "rate") if arm == "armed" else None
            rep, _, wall = run(ing["prefix"], ing["logs"], None, (), f"rate-{arm}", out_dir)
            base = base or strip(rep)
            check(strip(rep) == base, f"devprof rate run {i} ({arm}) changed the report")
            t = rep["totals"]
            rates[arm].append(t["sustained_lines_per_sec"])
            # the host's time around the loop: start-up, the export and parse
            walls[arm].append(wall - t["elapsed_sec"])
            if arm == "armed":
                windows.append(t["devprof"]["window_wall_sec"])
                check(t["devprof"]["attributed_frac"] >= 0.9,
                      f"devprof rate run {i}: attributed_frac {t['devprof']['attributed_frac']}")
    for arm in ("disarmed", "armed"):
        r = sorted(rates[arm])
        w = sorted(walls[arm])
        say(f"devprof rate: {arm}: sustained_lines_per_sec {r} (median "
            f"{(r[2] + r[3]) / 2:.1f}); wall outside elapsed (s) {[round(x, 3) for x in w]} "
            f"(median {(w[2] + w[3]) / 2:.3f}); 16x256 text, {INGEST_TEXT_LINES} lines, batch "
            f"{b}, prefetch 2; runs in turns on {card}")
    say(f"devprof rate: window_wall_sec of the armed runs {sorted(windows)}")

    rc = cli.main(["run", "--ruleset", ing["prefix"], "--logs", ing["logs"], "--distributed",
                   "--num-processes", "1", "--process-id", "0", "--devprof-out",
                   os.path.join(d, "never"), "--json"])
    check(rc == 2, f"devprof: run --distributed --devprof-out exited {rc}, want 2")
    say("devprof: run --distributed --num-processes 1 --devprof-out refused (exit 2)")
    return dict(launches)


def phase_default_rate(dev, card: str) -> None:
    """The default `run` (scan, prefetch 2, no profiling hooks armed) over a
    16x256 text corpus of 2^21 lines (synth --flows 65536 --skew 1.0) at
    batch 2^16, three times: its sustained_lines_per_sec.  Only the CLI, so
    `tools/torch_phase_turns.py --script` runs it against older checkouts."""
    from ruleset_analysis_tpu_torch import cli

    d = os.path.join(ROOT, "build", "smoke", "rate")
    prefix, logs = os.path.join(d, "parsed"), os.path.join(d, "fw1.log")
    if not os.path.exists(prefix + ".json"):
        check(cli.main(["synth", "--out-dir", d, "--acls", "16", "--rules", "256", "--lines",
                        str(INGEST_TEXT_LINES), "--flows", str(1 << 16), "--skew", "1.0",
                        "--seed", "0"]) == 0, "rate: synth failed")
        check(cli.main(["parse-acls", os.path.join(d, "fw1.cfg"), "--out", prefix]) == 0,
              "rate: parse-acls failed")
    for i in range(3):
        rep, _ = cli_run(prefix, logs, None, DEVPROF_B, tag=f"-rate{i}")
        t = rep["totals"]
        say(f"rate: default run {i}: sustained_lines_per_sec {t['sustained_lines_per_sec']}, "
            f"elapsed_sec {t['elapsed_sec']}, chunks {t['chunks']}; on {card}")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ruleset_analysis_tpu_torch")):
        print("chip_smoke: run it from a checkout (ruleset_analysis_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--counted-cli"]:
        return counted_cli(sys.argv[2], sys.argv[4:])
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
    k6 = phase_kernel6(dev)
    launches = phase_main_path(work)
    phase_full_width(work, card)
    ing, dual, stat, el = {}, {}, {}, {}

    def ingest():
        counts, ctx = phase_ingest(work, dev, card)
        ing.update(ctx)  # the feeder and stacked phases reuse its ruleset, corpus and oracle
        return counts

    def dual_stack():
        counts, ctx = phase_dual_stack(work, dev, card)
        dual.update(ctx)  # the stacked phase reuses its ruleset, corpora and oracle
        return counts

    for name, phase in (("phase_ingest", ingest),
                        ("phase_feeder", lambda: phase_feeder(work, dev, card, ing)),
                        ("phase_dual_stack", dual_stack),
                        ("phase_resume", lambda: phase_resume(work, dev, card)),
                        ("phase_stacked", lambda: phase_stacked(work, dev, card, ing, dual)),
                        ("phase_mesh", lambda: phase_mesh(dev, card)),
                        ("phase_distributed", lambda: phase_distributed(work, card, ing)),
                        ("phase_static",
                         lambda: phase_static(work, dev, card, ing, dual, stat)),
                        ("phase_faults", lambda: phase_faults(work, card)),
                        ("phase_metrics", lambda: phase_metrics(work, card)),
                        ("phase_elastic", lambda: phase_elastic(work, card, ing, el)),
                        ("phase_autoscale", lambda: phase_autoscale(work, card, ing, el))):
        t0 = time.perf_counter()
        for kernel, n in phase().items():
            launches[kernel] = launches.get(kernel, 0) + n
        say(f"{name} took {time.perf_counter() - t0:.1f} s")
    phase_device_step(dev, card)
    t0 = time.perf_counter()
    tail = phase_reg_tail(dev, card)
    phase_step_variants(dev, card)
    for name, n in phase_cli_variants(work, card).items():
        launches[name] = launches.get(name, 0) + n
    say(f"the update-paths phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernel_ms = {"first_match_kernel": k["rows"][("first_match", 7680)]["ms"],
                 "match_hist_kernel": k["rows"][("match_hist", 7680)]["ms"],
                 "first_match6_kernel": k6["row"]["ms"],
                 "reg_tail_kernel": tail["reg_tail"][0]["ms"],
                 "select_kernel": tail["select"][0]["ms"]}
    for name, n in phase_devprof(work, dev, card, ing, dual, kernel_ms).items():
        launches[name] = launches.get(name, 0) + n
    say(f"phase_devprof took {time.perf_counter() - t0:.1f} s")
    say(f"main() up to its last lines took {time.perf_counter() - t_start:.1f} s")

    rp_full = 7680
    src = {"first_match": ("ruleset_analysis_tpu_torch/csrc/first_match.cu",
                           "ruleset_analysis_tpu/ops/pallas_match.py:181"),
           "match_hist": ("ruleset_analysis_tpu_torch/csrc/match_hist.cu",
                          "ruleset_analysis_tpu/ops/pallas_fused.py:158"),
           "first_match6": ("ruleset_analysis_tpu_torch/csrc/first_match6.cu",
                            "ruleset_analysis_tpu/ops/match6.py:94"),
           "reg_tail": ("ruleset_analysis_tpu_torch/csrc/reg_tail.cu",
                        "ruleset_analysis_tpu/parallel/step.py:66"),
           "select": ("ruleset_analysis_tpu_torch/csrc/reg_tail.cu",
                      "ruleset_analysis_tpu/ops/topk.py:77"),
           "relation_tile": ("ruleset_analysis_tpu_torch/csrc/relation_tile.cu",
                             "ruleset_analysis_tpu/ops/overlap.py:62")}
    rows = {name: (k["rows"][(name, rp_full)], k["err"][name])
            for name in ("first_match", "match_hist")}
    rows["first_match6"] = (k6["row"], k6["err"])
    rows.update(tail)
    rows["relation_tile"] = (stat["row"], stat["err"])
    kernels = []
    for name, (source, replaces) in src.items():
        row, err = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was never launched on the main path")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
