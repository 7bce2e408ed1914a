"""Command-line interface of the port.

  python -m ruleset_analysis_tpu_torch.cli synth --out-dir DIR [--v6-fraction F] [...]
  python -m ruleset_analysis_tpu_torch.cli parse-acls CONFIG [...] --out PREFIX
  python -m ruleset_analysis_tpu_torch.cli convert --ruleset PREFIX --logs FILE... \\
      --out OUT.rawire [--coalesce] [--native-parse|--no-native-parse] \\
      [--feed-workers N | --workers N]
  python -m ruleset_analysis_tpu_torch.cli wire-info FILE... [--ruleset PREFIX]
  python -m ruleset_analysis_tpu_torch.cli run --ruleset PREFIX --logs FILE... \\
      [--match-impl {scan,fused,xla,pallas}] [--experimental-match-impl pallas_fused] \\
      [--counts-impl {scatter,matmul,reduce}] \\
      [--update-impl {scatter,sorted}] [--topk-every N] [--device {cuda,cpu}] [--prefetch-depth K] \\
      [--coalesce {off,on,auto}] [--native-parse|--no-native-parse] \\
      [--feed-workers N [--feed-mode {process,thread,ring}]] \\
      [--layout {flat,stacked} [--stacked-lane N]] [--mesh {flat,hybrid} [--mesh-dcn N]] \\
      [--distributed [--coordinator HOST:PORT] [--num-processes N] [--process-id I]] \\
      [--elastic --elastic-dir DIR [--max-reforms N] [--autoscale [--autoscale-min W] \\
      [--autoscale-max W] [--autoscale-initial W] [--autoscale-out-threshold F] \\
      [--autoscale-in-threshold F] [--autoscale-sustain SEC] [--autoscale-cooldown SEC] \\
      [--autoscale-budget N] [--autoscale-poll SEC] [--autoscale-plan SPEC]]] \\
      [--checkpoint-every N [--checkpoint-dir DIR]] [--resume] [--report-every N] \\
      [--cms-width W] [--cms-depth D] [--hll-p P] [--no-exact-counts] \\
      [--static-analysis [--static-witness-budget N]] [--fault-plan SPEC|@FILE] \\
      [--retry-policy SPEC] [--trace-out DIR] [--metrics-out FILE [--metrics-every SEC]] \\
      [--profile-dir DIR | --devprof-out DIR [--devprof-steps N] [--devprof-warmup K]] \\
      [--blackbox {on,off}] [--blackbox-dir DIR] [--json]
  python -m ruleset_analysis_tpu_torch.cli run --backend oracle --acl-configs CFG... [--lenient]
  python -m ruleset_analysis_tpu_torch.cli doctor BUNDLE [--exit-code RC] [--lineage PATH] [--json]
  python -m ruleset_analysis_tpu_torch.cli diff-reports OLD.json NEW.json [--top N] \\
      [--expect-window W] [--json]
  python -m ruleset_analysis_tpu_torch.cli analyze --ruleset PREFIX [--tile T] \\
      [--witness-budget N] [--fault-plan SPEC|@FILE] [--device {cuda,cpu}] [--json]
  python -m ruleset_analysis_tpu_torch.cli serve --ruleset PREFIX --listen SPEC... \\
      --window {lines:N|DURATION} --serve-dir DIR [--device {cuda,cpu}] [--ring N] \\
      [--view K]... [--http HOST:PORT|off] [--queue-lines N] [--max-windows N] \\
      [--stop-after SEC] [--checkpoint-every-windows N] [--checkpoint-dir DIR] [--resume] \\
      [--reload-watch|--no-reload-watch] [--static-analysis] [--wal ...] \\
      [--lineage {on,off}] [--slo SPEC] [--trend-threshold X] [...]

``run`` takes text syslog or ``.rawire`` files (not both in one list) and
runs on the CUDA device unless ``--device cpu`` is given; with no card it
exits 1 with a message.  A dual-stack ruleset (IPv4 and IPv6 rows) runs
both families through the same registers; its ``.rawire`` files are v2
(v3 when coalesced), with an IPv6 section after the v4 blocks.

The match defaults to ``scan`` (the first_match kernel; the reg_tail
kernel builds the counts), the counterpart of the reference's default
``xla``; the reference's ``--match-impl xla`` and ``pallas`` both select
it.  ``fused`` (the match_hist kernel, which builds the counts itself) is
the reference's opt-in ``--experimental-match-impl pallas_fused``, which
is accepted and overrides ``--match-impl`` as there.  ``fused`` refuses
weighted (``convert --coalesce``) files and ``--coalesce on|auto`` (exit
2), and so do ``--update-impl sorted``, ``--counts-impl matmul|reduce``
and ``--layout stacked`` with it.  The update and counts flags are the
reference's formulations of the register tail, accepted with its
refusals and run as the port's one tail, so they give the default
report.  Packed rulesets and wire files are the reference's formats, so
either package's ``parse-acls`` and ``convert`` output loads here.

``run --feed-workers N`` parses text files with N workers over file
shards (``--feed-mode``: spawned processes packing into shared memory,
threads, or one shared-memory ring per device copied to the card as it
is); the three modes give one report, whose registers, counts and unused
set equal the sequential run's.  ``convert --workers N`` writes N
pre-coalesced RAWIREv3 shards and makes ``--out`` a merge manifest, which
``run`` and ``wire-info`` read as one corpus.

``run --layout stacked`` buckets the lines by ACL on the host and steps
each grouped batch; the registers, counts and unused set are the flat
run's, and the whole report is the reference's stacked run's.

``run`` shards every batch over a mesh of every visible CUDA device
(``--mesh hybrid`` arranges them as ``--mesh-dcn`` outer groups; the
report is the flat mesh's); ``--device cpu`` runs on the one CPU device.
``run --distributed`` joins a ``torch.distributed`` job (``--coordinator
HOST:PORT``, else the ``env://`` variables; NCCL on the card, gloo with
``--device cpu``): each process runs its own ``--logs`` split on its own
device, and only process 0 prints the report.  It refuses stdin input
and ``--coalesce`` (exit 2).  ``run --distributed --elastic`` makes each
of ``--num-processes`` launchers an elastic supervisor
(``runtime/elastic.py``) over the same full shard list ``--logs``: the
analysis runs in a worker process a generation, saves a
world-size-independent epoch snapshot in ``--elastic-dir`` every
``--checkpoint-every`` chunks, and when a peer dies the survivors re-form
at the surviving world size and resume from it, at most
``--max-reforms`` times (then exit 7); the final generation's rank 0
prints the report, with ``totals.recovery``.  It needs ``--json``, text
shards and the launcher membership, and refuses ``--coordinator`` and
``--static-analysis`` (exit 2).  ``--autoscale`` (``runtime/autoscale.py``)
makes the launcher pool the largest world: the job starts at
``--autoscale-initial`` members, the rest park as warm standbys, and the
leader's policy re-forms it one rung out on sustained producer
backpressure and one rung in on sustained starvation (or on the scripted
``--autoscale-plan``), at most ``--autoscale-budget`` times (0: decide and
log, never act); the report gains ``totals.autoscale``.  An
``--autoscale-*`` knob without ``--autoscale``, or ``--autoscale`` without
``--elastic``, is a usage error (2).

``run --checkpoint-every N`` saves a snapshot every N chunks (and at the
end) in ``--checkpoint-dir`` (default ``$RA_OUTPUT_DIR/ckpt``); ``run
--resume`` over the same inputs and flags goes on from it and ends with
the report of a run that was never stopped.  Snapshots are the
reference's format, so either package resumes the other's.
``--backend oracle`` runs the exact pure-Python analysis over text logs
and the original configs (``--lenient`` parses those as ``parse-acls
--lenient`` does).

``analyze`` is the static analysis of a packed ruleset, with no traffic:
per-rule first-match verdicts (``runtime/staticanalysis.py``: the
``relation_grid`` kernel over the pair tiles, witness packets through
the ``first_match`` kernel), on the card unless ``--device cpu`` is
given.  ``--fault-plan`` arms a fault plan (a spec, or ``@FILE``) around
it; its one site is ``analyze.tile``.  ``run --static-analysis`` joins
the same verdicts into the report after the run, on every route (strict
with exact counts: a hit on a provably dead rule is an
``AnalyzerContradiction``, exit 1).

``run --fault-plan`` arms the reference's fault sites on the run path
(the host-to-device copy, the prefetch producer, the coalescer,
checkpoint writes, wire reads and blocks, the feed workers); the copy,
checkpoint and wire-read seams retry a transient failure with seeded
backoff (``--retry-policy``, ``runtime/retrypolicy.py``), so a ``site@N:k``
plan within the attempts gives the clean report.  ``--trace-out DIR``
records the run's spans and instants in per-process shards merged into
``DIR/trace.json``.  ``--metrics-out FILE`` appends the run's telemetry
to FILE as JSON lines: a snapshot every ``--metrics-every`` seconds
(lines and rates, RSS, the prefetch queue, the feeder, the coalescer, the
retry counters and the card's memory) and a ``final`` one at the end,
and events (a ``throughput`` line every ``--report-every`` chunks, a
``checkpoint`` a save).  ``--profile-dir DIR`` writes a whole-run
``torch.profiler`` trace there, the card's kernels included on a CUDA
run.  ``--devprof-out DIR`` captures a bounded window of ``--devprof-steps``
device steps after ``--devprof-warmup`` and attributes the card's time to
the ``ra.*`` stages in ``DIR/devprof.json`` and ``totals.devprof``
(runtime/devprof.py; not with ``--profile-dir``, ``--distributed`` or
``--elastic``).  The flight recorder is on by default (``--blackbox
on``): a typed abort, stall or crash writes ``postmortem.json`` in
``--blackbox-dir`` (default: ``blackbox`` beside the checkpoint dir), and
a clean exit leaves nothing; ``doctor`` turns a bundle into a ranked
diagnosis, joined with a window lineage ledger (``--lineage``, or a
``lineage.jsonl`` beside the bundle) into the publication frontier.  A
malformed ``--fault-plan`` or ``--retry-policy`` is a usage error (2).

``serve`` is the always-on service (runtime/serve.py): ``--listen``
specs (``udp:HOST:PORT``, ``tcp:HOST:PORT``, ``tail:PATH``,
``tail0:PATH``) feed windows of ``--window`` (``lines:N`` or a duration)
that step on the card (``--device cpu``: the plain versions); each
rotation publishes the window, cumulative, diff and ``--view`` merged
reports to ``--serve-dir`` and the HTTP endpoint, and SIGHUP or a changed
ruleset file hot-reloads the rules with counter migration.  Its refusals
and summary are the reference's.  ``--epoch-store DIR`` spills every
window into a durable epoch store and serves ``/report/range`` and
``/report/last-hit``; ``--autoscale`` resizes the mesh over the device
pool (every visible card, or the CPU with ``--device cpu``: one device,
so ``--autoscale-max`` above 1 needs more cards).  ``--tenants`` and
``--distributed`` are not served by the port yet (exit 2 after the
reference's own checks).

``diff-reports OLD NEW`` compares two JSON reports: the rules unused in
both (the deletion candidates), the newly unused and newly used ones,
ruleset churn, the top hit movers and, when both carry static verdicts,
the verdict transitions.  ``--expect-window W`` refuses (exit 1) two
reports that are not serve window reports of window ``W``.  Neither
``doctor`` nor ``diff-reports`` touches a device.

Exit codes are the reference's failure classes
(:func:`errors.exit_code_for`): 0 success; 1 an analysis error (parse
failure, missing input); 2 usage or an invalid configuration, a refused
weighted input included; 3 a damaged snapshot (``CheckpointCorrupt``); 4
a snapshot of another ruleset, sketch geometry, batch size or input kind,
or an input shorter than the snapshot's offset (``CheckpointMismatch``,
``ResumeInputMismatch``); 5 the feed failed (a dead feed worker, a
damaged wire block, a failed producer, no native parser); 6 the ingest
watchdog fired (``StallError``), or an elastic generation did not form;
7 an elastic run spent its ``--max-reforms``.
"""

from __future__ import annotations

import argparse
import sys

from . import errors
from .config import (
    COUNTS_IMPLS, FEED_MODES, LAYOUTS, MATCH_IMPL_ALIASES, MATCH_IMPLS, MESH_SHAPES,
    UPDATE_IMPLS, AnalysisConfig, AutoscaleConfig, DevprofConfig, ServeConfig, SketchConfig,
)
from .hostside import aclparse, pack, synth


def _cmd_parse_acls(args: argparse.Namespace) -> int:
    rulesets = []
    for path in args.configs:
        rs = aclparse.parse_config_file(path, strict=not args.lenient)
        skipped = f" skipped={len(rs.skipped)}" if rs.skipped else ""
        print(
            f"{path}: firewall={rs.firewall} acls={len(rs.acls)} "
            f"rules={rs.rule_count()} expanded_aces={rs.ace_count()}{skipped}",
            file=sys.stderr,
        )
        for lineno, reason, line in rs.skipped:
            print(f"{path}:{lineno}: skipped: {reason}: {line}", file=sys.stderr)
        rulesets.append(rs)
    packed = pack.pack_rulesets(rulesets)
    pack.save_packed(packed, args.out)
    v6 = f" (+ {packed.rules6.shape[0]} IPv6 ACE rows)" if packed.has_v6 else ""
    print(
        f"packed {packed.rules.shape[0]} ACE rows{v6}, {packed.n_rules} rule keys, "
        f"{packed.n_acls} ACLs -> {args.out}.npz/.json",
        file=sys.stderr,
    )
    return 0


def _iter_log_lines(paths: list[str]):
    for path in paths:
        if path == "-":
            yield from sys.stdin
        else:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                yield from f


def _oracle_usage_error(args: argparse.Namespace) -> int:
    """Exit code 2 (with a message) when ``--backend oracle`` is given flags
    it cannot honour, else 0.  Checked before the config is built, so a
    device-only flag is named even where its value would also be a
    refused combination (``--update-impl sorted`` with ``--match-impl
    fused``)."""
    from .hostside import wire

    if any(p != "-" and wire.is_wire_file(p) for p in args.logs):
        print("--backend=oracle reads text syslog; .rawire files only apply to "
              "--backend=tpu", file=sys.stderr)
        return 2
    # these only reach the device loop: accepting them would let a user
    # believe an oracle run is checkpointed.  The reference's order, so a
    # refusal naming several flags names them as the reference does
    # (--counts-impl is the port's own refusal, last)
    device_only = {
        "--checkpoint-every": args.checkpoint_every,
        "--resume": args.resume,
        "--report-every": args.report_every,
        "--profile-dir": args.profile_dir,
        "--trace-out": args.trace_out,
        "--metrics-out": args.metrics_out,
        "--native-parse": args.native_parse,
        "--checkpoint-dir": args.checkpoint_dir,
        "--layout=stacked": args.layout != "flat",
        "--packed-input": args.packed_input,
        "--no-exact-counts": not args.exact_counts,
        "--feed-workers": args.feed_workers > 1,
        "--feed-mode=thread": args.feed_workers > 1 and args.feed_mode == "thread",
        "--feed-mode=ring": args.feed_mode == "ring",
        "--experimental-match-impl": bool(args.experimental_match_impl),
        "--elastic": args.elastic,
        "--fault-plan": bool(args.fault_plan),
        "--retry-policy": bool(args.retry_policy),
        "--coalesce": args.coalesce != "off",
        "--mesh=hybrid": args.mesh != "flat",
        "--autoscale": args.autoscale,
        "--devprof-out": bool(args.devprof_out),
        "--update-impl=sorted": args.update_impl != "scatter",
        "--topk-every": args.topk_every != 1,
        "--blackbox-dir": bool(args.blackbox_dir),
        "--blackbox=off": args.blackbox == "off",
        "--counts-impl": args.counts_impl != "scatter",
    }
    bad = [k for k, v in device_only.items() if v]
    if bad:
        print(f"{', '.join(bad)} only apply to --backend=tpu", file=sys.stderr)
        return 2
    if not args.acl_configs:
        print("--backend=oracle requires --acl-configs (original config files)",
              file=sys.stderr)
        return 2
    return 0


def _run_oracle(args: argparse.Namespace, packed):
    """The exact pure-Python analysis (``--backend oracle``): a Report."""
    from .hostside import oracle
    from .runtime import report as report_mod

    rulesets = [aclparse.parse_config_file(p, strict=not args.lenient) for p in args.acl_configs]
    res = oracle.Oracle(rulesets).consume(_iter_log_lines(args.logs))
    # talker identities are (family, address): a v6 source renders as v6
    talkers = {
        k: [(aclparse.int_to_ip6(s) if f == 6 else aclparse.u32_to_ip(s), c)
            for (f, s), c in cnt.most_common(args.topk)]
        for k, cnt in res.talkers.items()
    }
    return report_mod.build_report(
        packed, dict(res.hits), backend="oracle",
        totals={"lines_total": res.lines_total, "lines_matched": res.lines_matched,
                "lines_skipped": res.lines_skipped},
        unique_sources={k: len(v) for k, v in res.sources.items()},
        talkers=talkers,
    )


def _feed_usage_error(args: argparse.Namespace, file_input: bool, wire_input: bool) -> str:
    """The reference's refusals of the feed flags: a message, or "" when none."""
    if wire_input and (args.native_parse or args.feed_workers > 1):
        return ("--native-parse/--feed-workers do not apply to packed .rawire inputs "
                "(there is no text parse)")
    if args.native_parse and not file_input:
        return "--native-parse requires file inputs (not '-')"
    if args.feed_workers > 1 and (not file_input or args.distributed
                                  or args.native_parse is False):
        return ("--feed-workers requires file inputs and the native parser, and is not "
                "available with --distributed")
    if args.feed_mode == "ring" and args.feed_workers < 1:
        return "--feed-mode ring needs --feed-workers N (the per-chip producer pool size)"
    if args.feed_mode == "ring" and (not file_input or args.distributed
                                     or args.native_parse is False or wire_input):
        return ("--feed-mode ring requires text file inputs and the native parser, and is "
                "not available with --distributed")
    return ""


def _match_impl(args: argparse.Namespace) -> str:
    """The port's match impl: ``--experimental-match-impl`` overrides
    ``--match-impl``, as in the reference, and the reference's spellings
    map onto the port's impls."""
    impl = args.experimental_match_impl or args.match_impl
    return MATCH_IMPL_ALIASES.get(impl, impl)


def _resolve_fault_plan(spec: str | None) -> str:
    """``--fault-plan`` value: a spec string, or ``@FILE`` naming a file
    holding one.  Validated by parsing; returns the canonical form."""
    if not spec:
        return ""
    from .runtime import faults

    if spec.startswith("@"):
        try:
            with open(spec[1:], "r", encoding="utf-8") as f:
                spec = f.read().strip()
        except OSError as e:
            raise errors.AnalysisError(f"cannot read fault plan file {spec[1:]!r}: {e}") from e
    return faults.FaultPlan.parse(spec).to_str()


def _resolve_blackbox(args: argparse.Namespace, default_dir: str) -> str:
    """``--blackbox`` / ``--blackbox-dir`` -> the recorder's directory ("" = off).

    On by default: a run needs no flag to leave crash forensics.
    ``--blackbox off`` disarms; ``RA_BLACKBOX=off`` disarms only the
    default (an explicit ``--blackbox-dir`` still arms).  ``--blackbox off
    --blackbox-dir D`` contradicts itself: AnalysisError.
    """
    import os

    from .runtime import flightrec

    if args.blackbox == "off":
        if args.blackbox_dir:
            raise errors.AnalysisError("--blackbox-dir contradicts --blackbox off (drop one)")
        return ""
    if not args.blackbox_dir and os.environ.get(
            flightrec.KILL_SWITCH, "").strip().lower() in ("off", "0"):
        return ""
    return args.blackbox_dir or default_dir


#: --autoscale-X flag -> AutoscaleConfig field; the dataclass defaults are
#: the flags' defaults (the argparse defaults and the requires---autoscale
#: check both read them)
_AUTOSCALE_FIELDS = {
    "autoscale_min": "min_world",
    "autoscale_max": "max_world",
    "autoscale_initial": "initial_world",
    "autoscale_out_threshold": "out_threshold",
    "autoscale_in_threshold": "in_threshold",
    "autoscale_sustain": "sustain_sec",
    "autoscale_cooldown": "cooldown_sec",
    "autoscale_budget": "reform_budget",
    "autoscale_poll": "poll_sec",
    "autoscale_plan": "plan",
}


def _autoscale_defaults() -> dict:
    import dataclasses

    by_field = {f.name: f.default for f in dataclasses.fields(AutoscaleConfig)}
    return {flag: by_field[field] for flag, field in _AUTOSCALE_FIELDS.items()}


def _autoscale_config(args: argparse.Namespace) -> AutoscaleConfig | None:
    """The ``--autoscale`` flag family -> AutoscaleConfig (None when off);
    a knob without ``--autoscale`` is an AnalysisError (a usage error)."""
    if not args.autoscale:
        for flag, dflt in _autoscale_defaults().items():
            if getattr(args, flag) != dflt:
                raise errors.AnalysisError(f"--{flag.replace('_', '-')} requires --autoscale")
        return None
    return AutoscaleConfig(**{field: getattr(args, flag)
                              for flag, field in _AUTOSCALE_FIELDS.items()})


def _add_autoscale_flags(p: argparse.ArgumentParser) -> None:
    d = _autoscale_defaults()
    p.add_argument("--autoscale", action="store_true",
                   help="arm the metrics-driven elastic autoscaler: sustained producer "
                        "backpressure scales the world OUT, sustained starvation scales it "
                        "IN, by planned re-formations from the epoch checkpoints; decisions "
                        "carry their evidence in the trace and metrics planes")
    p.add_argument("--autoscale-min", type=int, default=d["autoscale_min"], metavar="W",
                   help="smallest world the policy may scale in to")
    p.add_argument("--autoscale-max", type=int, default=d["autoscale_max"], metavar="W",
                   help="largest world (0 = the launcher pool of --elastic)")
    p.add_argument("--autoscale-initial", type=int, default=d["autoscale_initial"],
                   metavar="W", help="starting world (0 = the smallest allowed)")
    p.add_argument("--autoscale-out-threshold", type=float,
                   default=d["autoscale_out_threshold"], metavar="F",
                   help="scale OUT when the pressure signal holds >= F over the sustain "
                        "window (the share of wall time the producer was backpressured)")
    p.add_argument("--autoscale-in-threshold", type=float,
                   default=d["autoscale_in_threshold"], metavar="F",
                   help="scale IN when the starvation signal holds >= F over the sustain "
                        "window")
    p.add_argument("--autoscale-sustain", type=float, default=d["autoscale_sustain"],
                   metavar="SEC", help="a signal must hold this long before a decision")
    p.add_argument("--autoscale-cooldown", type=float, default=d["autoscale_cooldown"],
                   metavar="SEC", help="dead time after every decision (flap damping)")
    p.add_argument("--autoscale-budget", type=int, default=d["autoscale_budget"], metavar="N",
                   help="scale re-formations allowed a run (0 = observe-only: decisions with "
                        "evidence, no actuation); apart from --max-reforms, which stays the "
                        "FAILURE budget")
    p.add_argument("--autoscale-poll", type=float, default=d["autoscale_poll"], metavar="SEC",
                   help="metrics sampling cadence of the policy engine")
    p.add_argument("--autoscale-plan", default=d["autoscale_plan"], metavar="SPEC",
                   help="scripted decisions for drills and tests ('out@T,in@T': fire at T "
                        "seconds, in order), past the signal thresholds")


def _static_usage_error(args: argparse.Namespace) -> str:
    """The reference's refusals of the static-analysis flags: a message, or
    "" when none.  Checked before the ruleset loads and the run starts."""
    if not args.static_analysis and args.static_witness_budget != 4096:
        return "--static-witness-budget requires --static-analysis"
    if args.static_analysis and args.static_witness_budget < 1:
        return "--static-witness-budget must be >= 1"
    return ""


def _cmd_run(args: argparse.Namespace) -> int:
    from .hostside import wire
    from .hostside.convertfleet import expand_wire_inputs
    from .runtime.stream import run_stream, run_stream_file, run_stream_wire

    import os

    if args.backend == "oracle" and _oracle_usage_error(args):
        return 2
    try:
        # the recorder's default home is beside the checkpoint dir
        # ("out/ckpt" -> "out/blackbox")
        ckpt_dir = args.checkpoint_dir or AnalysisConfig.checkpoint_dir
        blackbox_dir = _resolve_blackbox(
            args, os.path.join(os.path.dirname(ckpt_dir) or ".", "blackbox"),
        ) if args.backend == "tpu" else ""
        cfg = AnalysisConfig(
            batch_size=args.batch_size,
            sketch=SketchConfig(
                cms_width=args.cms_width,
                cms_depth=args.cms_depth,
                hll_p=args.hll_p,
                topk_sample_shift=args.topk_sample_shift,
                topk_every=args.topk_every,
            ),
            exact_counts=args.exact_counts,
            register_memory_budget_bytes=args.register_budget_mb << 20,
            match_impl=_match_impl(args),
            counts_impl=args.counts_impl,
            update_impl=args.update_impl,
            layout=args.layout,
            stacked_lane=args.stacked_lane,
            device=args.device,
            mesh_shape=args.mesh,
            mesh_dcn=args.mesh_dcn,
            prefetch_depth=args.prefetch_depth,
            stall_timeout_sec=args.stall_timeout,
            coalesce=args.coalesce,
            checkpoint_every_chunks=args.checkpoint_every,
            resume=args.resume,
            report_every_chunks=args.report_every,
            fault_plan=_resolve_fault_plan(args.fault_plan),
            retry_policy=args.retry_policy,
            blackbox_dir=blackbox_dir,
            **({"checkpoint_dir": args.checkpoint_dir} if args.checkpoint_dir else {}),
        )
        if args.retry_policy:
            # validated here: a malformed spec is a usage error now, not
            # a failure at the first transient fault
            from .runtime import retrypolicy

            retrypolicy.parse_spec(args.retry_policy)
        autoscale = _autoscale_config(args)
    except (ValueError, errors.AnalysisError) as e:
        # an AnalysisError here is a malformed --fault-plan/--retry-policy,
        # contradictory --blackbox flags or an --autoscale-* knob without
        # --autoscale: a usage error, not a runtime failure class
        print(f"error: {e}", file=sys.stderr)
        return 2
    refusal = _static_usage_error(args)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    if args.backend == "oracle":
        packed = pack.load_packed(args.ruleset)
        return _emit(_run_oracle(args, packed), args, packed)
    # a convert-fleet manifest stands for its shards, in order: the
    # multi-file wire reader takes them as one corpus
    args.logs = expand_wire_inputs(args.logs)
    # '-' (stdin) is never a wire file but still poisons a mix: binary
    # wire data must not fall through to the text parser
    n_wire = sum(1 for p in args.logs if p != "-" and wire.is_wire_file(p))
    if args.packed_input and n_wire < len(args.logs):
        print("--packed-input: not every --logs file is a .rawire wire file "
              "(run `convert` first)", file=sys.stderr)
        return 2
    if 0 < n_wire < len(args.logs):
        print("cannot mix .rawire and text inputs in one --logs list", file=sys.stderr)
        return 2
    wire_input = n_wire > 0
    refusal = _feed_usage_error(args, "-" not in args.logs, wire_input)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    packed = pack.load_packed(args.ruleset)
    if args.trace_out or args.metrics_out:
        # the whole run's spans land in per-process shards in --trace-out
        # (spawned workers inherit RA_TRACE_DIR), its snapshots and events
        # in --metrics-out; main()'s finally merges and stops them, after a
        # typed abort too
        from .runtime import obs

        try:
            if args.trace_out:
                obs.start_trace(args.trace_out, role="main")
            if args.metrics_out:
                obs.start_metrics(args.metrics_out, args.metrics_every)
                # the card's memory in every snapshot (nulls on the CPU)
                obs.register_sampler("device_mem", _device_mem_sampler(args.device))
        except OSError as e:
            print(f"error: cannot open --trace-out/--metrics-out target: {e}", file=sys.stderr)
            return 2
    if args.autoscale and not args.elastic:
        print("--autoscale applies to `serve` and to `run --elastic` (the supervised "
              "tier that can re-form the world); a fixed-membership run has nothing to scale",
              file=sys.stderr)
        return 2
    rc = _arm_devprof(args)
    if rc is not None:
        return rc
    if args.elastic:
        return _run_elastic(args, cfg, "-" not in args.logs, wire_input, autoscale)
    if args.distributed:
        return _run_distributed(args, cfg, packed)
    if wire_input:
        # a weighted file with a match_impl that is not weight-linear
        # raises WeightedInputRefused: exit 2, like the config refusals
        rep = run_stream_wire(packed, args.logs, cfg, topk=args.topk,
                              profile_dir=args.profile_dir)
    elif "-" in args.logs:
        rep = run_stream(packed, _iter_log_lines(args.logs), cfg, topk=args.topk,
                         profile_dir=args.profile_dir)
    else:
        # --native-parse with no C++ toolchain raises NativeParserUnavailable
        rep = run_stream_file(packed, args.logs, cfg, native=args.native_parse, topk=args.topk,
                              feed_workers=args.feed_workers, feed_mode=args.feed_mode,
                              profile_dir=args.profile_dir)
    return _emit(rep, args, packed)


def _arm_devprof(args: argparse.Namespace) -> int | None:
    """Validate and arm the device attribution capture (``--devprof-out``).

    Returns an exit code on a usage error, None on success (the disarmed
    default included).
    """
    if not args.devprof_out:
        if (args.devprof_steps != DevprofConfig.steps
                or args.devprof_warmup != DevprofConfig.warmup):
            print("--devprof-steps/--devprof-warmup require --devprof-out", file=sys.stderr)
            return 2
        return None
    if getattr(args, "distributed", False) or getattr(args, "elastic", False):
        # one process's window and trace: a multi-process job would
        # publish a summary missing every other rank's device time
        print(
            "--devprof-out is a single-controller capture and is "
            "incompatible with --distributed/--elastic; capture on a "
            "single-process run of the same geometry instead",
            file=sys.stderr,
        )
        return 2
    if getattr(args, "profile_dir", None):
        print(
            "--devprof-out and --profile-dir both drive torch.profiler "
            "(one trace session per process); pick one — devprof is the "
            "bounded window with semantic attribution, profile-dir the "
            "whole-run TensorBoard trace",
            file=sys.stderr,
        )
        return 2
    from .runtime import devprof

    try:
        dcfg = DevprofConfig(out_dir=args.devprof_out, steps=args.devprof_steps,
                             warmup=args.devprof_warmup)
        devprof.arm(dcfg.out_dir, steps=dcfg.steps, warmup=dcfg.warmup,
                    mem_gauges=_device_mem_sampler(args.device))
    except (ValueError, errors.AnalysisError, OSError) as e:
        print(f"error: cannot arm --devprof-out: {e}", file=sys.stderr)
        return 2
    return None


def _device_mem_sampler(device: str):
    """The ``device_mem`` sampler of a run on ``device``: bound to the card
    the run uses (the current CUDA device of this thread, which a
    distributed run has set to its rank's), since the sampler runs on the
    ``ra-metrics`` thread; three nulls on the CPU or without a card."""
    import functools

    from .runtime.devprof import device_memory_gauges

    if device == "cuda":
        import torch

        if torch.cuda.is_available():
            return functools.partial(device_memory_gauges,
                                     torch.device("cuda", torch.cuda.current_device()))
    return device_memory_gauges


def _run_distributed(args: argparse.Namespace, cfg: AnalysisConfig, packed) -> int:
    """``run --distributed``: join the job, run this process's ``--logs``
    split; process 0 emits the report."""
    from .parallel import distributed as dist
    from .runtime.stream import run_stream_file_distributed

    if "-" in args.logs:
        print("--distributed requires file inputs (not '-')", file=sys.stderr)
        return 2
    if args.coalesce != "off":
        print("--coalesce applies to single-process runs only; for distributed jobs "
              "pre-coalesce the input with `convert --coalesce`", file=sys.stderr)
        return 2
    dist.init_distributed(args.coordinator, args.num_processes, args.process_id,
                          device=cfg.device)
    try:
        from .runtime import obs

        if obs.metrics_active():
            # the rank's card, which init_distributed made current
            obs.register_sampler("device_mem", _device_mem_sampler(cfg.device))
        rep = run_stream_file_distributed(packed, args.logs, cfg, native=args.native_parse,
                                          topk=args.topk, profile_dir=args.profile_dir)
        rank = dist.process_index()
    finally:
        dist.shutdown()
    return _emit(rep, args, packed) if rank == 0 else 0


def _elastic_usage_error(args: argparse.Namespace, file_input: bool, wire_input: bool) -> str:
    """The reference's refusals of ``--elastic``: a message, or "" when none."""
    if not args.distributed:
        return "--elastic requires --distributed"
    if not file_input or wire_input:
        return "--elastic requires text file shards (not '-' or .rawire)"
    if args.num_processes is None or args.process_id is None:
        return "--elastic requires --num-processes and --process-id (the launcher membership)"
    if args.coordinator:
        return "--elastic elects its own coordinator; drop --coordinator"
    if not args.elastic_dir:
        return ("--elastic requires --elastic-dir (shared rendezvous + epoch-checkpoint "
                "directory)")
    if not args.json:
        return "--elastic reports via the JSON result the workers write; add --json"
    if args.static_analysis:
        return ("--static-analysis does not ride the --elastic result relay; run the "
                "`analyze` subcommand against the same --ruleset instead")
    return ""


def _run_elastic(args: argparse.Namespace, cfg: AnalysisConfig, file_input: bool,
                 wire_input: bool, autoscale: AutoscaleConfig | None) -> int:
    """``run --distributed --elastic``: this process becomes a recovery
    supervisor (``runtime/elastic.py``) over the full shard list, the same
    on every launcher; it spawns the generation workers, and the member
    whose worker held rank 0 of the final generation relays the report.
    With ``autoscale`` it also parks as a standby or, as the leader, runs
    the policy controller."""
    import json
    import os

    from .runtime import faults, flightrec
    from .runtime.elastic import ElasticSupervisor

    refusal = _elastic_usage_error(args, file_input, wire_input)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    if cfg.device == "cuda":
        import torch

        # no card: the plain run's exit 1, before any worker starts (and
        # without a CUDA context in the supervisor)
        if not torch.cuda.is_available():
            raise errors.DeviceUnavailable(
                "no CUDA device is available; pass --device cpu to run an elastic job on "
                "the CPU over gloo")
    fault = None
    fault_env = os.environ.get("RA_ELASTIC_FAULT")
    if fault_env:
        # fault injection: "tag=K,after_batches=M[,gen=G]"
        fault = dict(kv.split("=", 1) for kv in fault_env.split(","))
    try:
        sup = ElasticSupervisor(
            args.elastic_dir, args.process_id, args.num_processes, args.ruleset, args.logs,
            cfg, max_reforms=args.max_reforms, topk=args.topk, native=args.native_parse,
            out_prefix=os.path.join(args.elastic_dir, "result"), fault=fault,
            autoscale=autoscale,
        )
    except errors.AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # the supervisor owns the blackbox dir: it arms first (pruning stale
    # shards), and its workers join through the exported RA_BLACKBOX_DIR;
    # the fault plan it arms (the autoscale sites fire here) reaches them
    # through RA_FAULT_PLAN
    if cfg.blackbox_dir:
        flightrec.arm(cfg.blackbox_dir, role="elastic-supervisor")
    armed_here = faults.arm_spec(cfg.fault_plan)
    try:
        rc, result_path = sup.run()
    except errors.AnalysisError as e:
        # a typed abort exits with its failure class; noted, so the
        # finalize in main()'s finally merges the workers' shards instead
        # of pruning them as after a clean exit
        rc = errors.exit_code_for(e)
        flightrec.note_abort(e, rc)
        print(f"error: {e}", file=sys.stderr)
        return rc
    finally:
        if armed_here:
            faults.disarm()
    if rc != 0:
        # a failure the supervisor reported by exit code alone
        flightrec.note_failure(rc)
        return rc
    if result_path is None:
        return 0  # another member relays the report
    with open(result_path, "r", encoding="utf-8") as f:
        _write(json.dumps(json.load(f), indent=2), args.out)
    return 0


def _emit(rep, args: argparse.Namespace, packed) -> int:
    """Print or write the report; with ``--static-analysis`` join the static
    verdicts into it first (every route of ``run`` ends here)."""
    if args.static_analysis:
        from .runtime import staticanalysis

        sa = staticanalysis.analyze_ruleset(packed, witness_budget=args.static_witness_budget,
                                            device=args.device)
        # strict only with exact counters: a CMS estimate can put a dead
        # rule above zero (the oracle always counts exactly)
        staticanalysis.attach_static(rep, packed, sa, strict=args.exact_counts)
    _write(rep.to_json() if args.json else rep.to_text(), args.out)
    return 0


def _write(payload: str, out: str | None) -> None:
    """``payload`` to the file ``out``, or to stdout without one."""
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(payload + "\n")
    else:
        print(payload)


def _cmd_diff_reports(args: argparse.Namespace) -> int:
    """Compare two JSON reports: the operator's delete-decision view.

    One run cannot say which rules are safe to delete (a rule may be quiet
    this week); the diff shows stability across runs: rules unused in both
    reports are the deletion candidates, newly unused and newly used rules
    the churn to investigate (runtime/report.py ``diff_report_objs``).
    Touches no device.
    """
    import json

    from .runtime import report as report_mod

    if args.top < 0:
        print("error: --top must be >= 0", file=sys.stderr)
        return 2

    def load(path):
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    try:
        rep_a, rep_b = load(args.old), load(args.new)
        if args.expect_window:
            # a typed refusal: a 24h window diffed against a 7d window is a
            # misleading answer (main() maps the exit code)
            report_mod.check_window_compat(rep_a, rep_b, args.expect_window)
        out = report_mod.diff_report_objs(rep_a, rep_b, top=args.top)
    except errors.AnalysisError:
        raise
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"error: unreadable report: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    print(f"# stable unused (deletion candidates): {len(out['stable_unused'])}")
    for k in out["stable_unused"]:
        print(f"  {k}")
    print(f"# newly unused (quiet this run): {len(out['newly_unused'])}")
    for k in out["newly_unused"]:
        print(f"  {k}")
    print(f"# newly used (were unused before): {len(out['newly_used'])}")
    for k in out["newly_used"]:
        print(f"  {k}")
    if out["rules_added"] or out["rules_removed"]:
        print(f"# ruleset churn: {len(out['rules_added'])} added, "
              f"{len(out['rules_removed'])} removed between reports")
    if out["top_hit_movers"]:
        print("# top hit movers:")
        for m in out["top_hit_movers"]:
            print(f"  {m['rule']}: {m['old']} -> {m['new']}")
    if out.get("verdict_transitions"):
        print(f"# static verdict transitions: {len(out['verdict_transitions'])}"
              " (a rule changing reachability class across a ruleset change)")
        for m in out["verdict_transitions"]:
            print(f"  {m['rule']}: {m['old']} -> {m['new']}")
    if out.get("window_incomplete"):
        print(f"# WARNING: incomplete window(s): {', '.join(out['window_incomplete'])}"
              " — churn there may be drop artifacts, not traffic")
    return 0


def _cmd_doctor(args: argparse.Namespace) -> int:
    """A postmortem bundle and an exit code -> a ranked diagnosis.

    Reads the ``postmortem.json`` a failed run's flight recorder merged
    and names the failing stage, the fired fault sites and the next
    action (runtime/flightrec.py ``diagnose``); joined with a window
    lineage ledger (``--lineage``, else a ``lineage.jsonl`` found beside
    the bundle), it also names the publication frontier.
    """
    import json

    from .runtime import flightrec
    from .runtime.report import lineage_frontier

    try:
        bundle = flightrec.load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"error: unreadable postmortem bundle: {e}", file=sys.stderr)
        return 1
    lpath = args.lineage or flightrec.find_lineage(args.bundle)
    lineage = flightrec.load_lineage(lpath) if lpath else []
    diags = flightrec.diagnose(bundle, exit_code=args.exit_code, lineage=lineage)
    if args.json:
        payload = json.dumps({
            "trigger": bundle.get("trigger"),
            "exit_code": args.exit_code if args.exit_code is not None else bundle.get("exit_code"),
            "error": bundle.get("error"),
            "error_type": bundle.get("error_type"),
            "failing_stage": bundle.get("analysis", {}).get("failing_stage"),
            "lineage_path": lpath,
            "lineage_frontier": lineage_frontier(lineage) if lineage else None,
            "diagnosis": diags,
        }, indent=2)
    else:
        payload = flightrec.render_diagnosis(bundle, diags)
    _write(payload, args.out)
    return 0


def _cmd_analyze(args: argparse.Namespace) -> int:
    """Static ruleset analysis (no traffic): per-rule reachability verdicts
    from the packed rule tensor alone (runtime/staticanalysis.py)."""
    import json

    from .runtime import faults, staticanalysis

    if args.witness_budget < 1:
        print("error: --witness-budget must be >= 1", file=sys.stderr)
        return 2
    if args.tile is not None and args.tile < 1:
        print("error: --tile must be >= 1", file=sys.stderr)
        return 2
    packed = pack.load_packed(args.ruleset)
    armed_here = faults.arm_spec(_resolve_fault_plan(args.fault_plan))
    try:
        sa = staticanalysis.analyze_ruleset(packed, tile=args.tile,
                                            witness_budget=args.witness_budget,
                                            device=args.device)
    finally:
        if armed_here:
            faults.disarm()
    obj = sa.to_obj(packed)
    _write(json.dumps(obj, indent=2) if args.json else staticanalysis.render_text(packed, obj),
           args.out)
    return 0


#: the serve modes the port does not run yet, and the ROADMAP item each waits for
_SERVE_DEFERRED = {"--tenants": "A9", "--distributed": "A10"}


def _serve_deferred(flag: str) -> int:
    print(f"error: serve {flag} is not served by the port yet "
          f"(ROADMAP {_SERVE_DEFERRED[flag]})", file=sys.stderr)
    return 2


def _cmd_serve(args: argparse.Namespace) -> int:
    """Always-on service mode: live listeners -> windowed reports
    (runtime/serve.py), on the card unless ``--device cpu``.

    Every refusal is the reference's, in its order; the two modes the
    port does not run yet (:data:`_SERVE_DEFERRED`) exit 2 after the
    reference's own checks.
    """
    import json
    import os

    from .runtime import report

    if not args.static_analysis and args.static_witness_budget != 4096:
        print("error: --static-witness-budget requires --static-analysis", file=sys.stderr)
        return 2
    if bool(args.ruleset) == bool(args.tenants):
        print("error: serve needs exactly one of --ruleset or --tenants MANIFEST",
              file=sys.stderr)
        return 2
    if not args.distributed:
        for flag, dflt in (
            ("dist_hosts", 2), ("dist_min_hosts", 1),
            ("dist_max_hosts", 0), ("dist_workers", "process"),
            ("dist_merge_bind", "127.0.0.1:0"),
            ("dist_merge_timeout", 120.0), ("dist_respawn", False),
            ("dist_lease_ttl", 2.0), ("dist_spool_dir", ""),
            ("dist_spool_budget_mb", 64),
        ):
            if getattr(args, flag) != dflt:
                print(f"error: --{flag.replace('_', '-')} requires --distributed",
                      file=sys.stderr)
                return 2
    try:
        cfg = AnalysisConfig(
            mesh_shape=args.mesh,
            batch_size=args.batch_size,
            sketch=SketchConfig(
                cms_width=args.cms_width,
                cms_depth=args.cms_depth,
                hll_p=args.hll_p,
                topk_every=args.topk_every,
            ),
            register_memory_budget_bytes=args.register_budget_mb << 20,
            resume=args.resume,
            stall_timeout_sec=args.stall_timeout,
            update_impl=args.update_impl,
            device=args.device,
            fault_plan=_resolve_fault_plan(args.fault_plan),
            retry_policy=args.retry_policy,
            # beside the serve dir, like the ring checkpoint
            blackbox_dir=_resolve_blackbox(args, os.path.join(args.serve_dir, "blackbox")),
        )
        if args.retry_policy:
            from .runtime import retrypolicy

            retrypolicy.parse_spec(args.retry_policy)
        ascfg = _autoscale_config(args)
        mode, length = report.parse_window_spec(args.window)
        scfg = ServeConfig(
            listen=tuple(args.listen),
            window_lines=int(length) if mode == "lines" else 0,
            window_sec=length if mode == "sec" else 0.0,
            ring=args.ring,
            views=tuple(args.view),
            queue_lines=args.queue_lines,
            http=args.http,
            serve_dir=args.serve_dir,
            checkpoint_every_windows=args.checkpoint_every_windows,
            checkpoint_dir=args.checkpoint_dir or "",
            reload_watch=args.reload_watch,
            reload_poll_sec=args.reload_poll,
            max_windows=args.max_windows,
            stop_after_sec=args.stop_after,
            static_analysis=args.static_analysis,
            static_witness_budget=args.static_witness_budget,
            wal=args.wal,
            wal_dir=args.wal_dir,
            wal_segment_bytes=args.wal_segment_kb << 10,
            wal_budget_bytes=args.wal_budget_mb << 20,
            lineage=args.lineage != "off",
            slo=args.slo,
            trend_threshold=args.trend_threshold,
            epoch_store=args.epoch_store,
            epoch_store_budget_bytes=args.epoch_store_budget_mb << 20,
        )
    except (ValueError, errors.AnalysisError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from .runtime.serve import ServeDriver

    if args.trace_out or args.metrics_out:
        from .runtime import obs

        try:
            if args.trace_out:
                obs.start_trace(args.trace_out, role="serve")
            if args.metrics_out:
                obs.start_metrics(args.metrics_out, args.metrics_every)
                obs.register_sampler("device_mem", _device_mem_sampler(args.device))
        except OSError as e:
            print(f"error: cannot open --trace-out/--metrics-out target: {e}", file=sys.stderr)
            return 2
    rc = _arm_devprof(args)
    if rc is not None:
        return rc
    if args.tenants:
        if ascfg is not None:
            print("error: --autoscale does not combine with --tenants (the tenancy plane "
                  "packs many rulesets onto one fixed mesh)", file=sys.stderr)
            return 2
        return _serve_deferred("--tenants")
    if args.distributed:
        return _serve_deferred("--distributed")
    try:
        # construction binds the listener sockets and the HTTP endpoint: a
        # privileged port or an address in use is the clean error
        driver = ServeDriver(args.ruleset, cfg, scfg, topk=args.topk, ascfg=ascfg)
    except OSError as e:
        print(f"error: cannot bind --listen/--http: {e}", file=sys.stderr)
        return 2
    try:
        summary = driver.run()
    except OSError as e:
        print(f"error: serve I/O failure: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_convert(args: argparse.Namespace) -> int:
    """Text syslog -> pre-tokenized .rawire wire file (parse once), or with
    ``--workers N`` N weighted shards and a merge manifest at ``--out``."""
    from .hostside import wire
    from .hostside.convertfleet import convert_logs_fleet, is_manifest_file

    if args.block_rows < 1:
        print("error: --block-rows must be >= 1", file=sys.stderr)
        return 2
    already = [p for p in args.logs if wire.is_wire_file(p) or is_manifest_file(p)]
    if already:
        # a shell glob catching *.rawire must not "convert" binary data
        # through the text parser into a valid-but-empty wire file
        print(f"error: {already[0]!r} is already a wire file; convert takes "
              "text syslog inputs", file=sys.stderr)
        return 2
    packed = pack.load_packed(args.ruleset)
    if args.workers >= 1:
        if args.native_parse is False:
            print("error: --workers requires the native parser", file=sys.stderr)
            return 2
        # --block-rows is also the descriptor size: shards split, and
        # batches coalesce, at its multiples, so the stored stream is a
        # function of (corpus, --block-rows) alone; always weighted
        stats = convert_logs_fleet(packed, args.logs, args.out, workers=args.workers,
                                   batch_size=args.block_rows, block_rows=args.block_rows)
    else:
        stats = wire.convert_logs(
            packed, args.logs, args.out, native=args.native_parse,
            block_rows=args.block_rows, coalesce=args.coalesce,
            feed_workers=args.feed_workers,
        )
    if stats["weighted"]:
        stored = stats["rows"] + stats["rows6"]
        ratio = stats["evals"] / max(stored, 1)
        shape = (f"{stored} weighted rows for {stats['evals']} evaluations "
                 f"(compaction {ratio:.2f}x)")
    else:
        shape = f"{stats['evals']} evaluation rows"
    v6 = f" ({stats['rows6']} v6)" if stats["rows6"] else ""
    print(
        f"wrote {args.out}: {shape}{v6} from {stats['raw_lines']} lines "
        f"({stats['skipped']} skipped), {stats['bytes'] / 1e6:.1f} MB, "
        f"parser={stats['parser']}",
        file=sys.stderr,
    )
    return 0


def _cmd_wire_info(args: argparse.Namespace) -> int:
    """Inspect .rawire headers; optionally validate against a ruleset."""
    import json

    from .hostside import wire
    from .hostside.convertfleet import expand_wire_inputs

    args.files = expand_wire_inputs(args.files)
    fp = wire.ruleset_fingerprint(pack.load_packed(args.ruleset)) if args.ruleset else None
    rc = 0
    rows = []
    for path in args.files:
        try:
            r = wire.WireReader([path], fingerprint=fp)
        except (errors.AnalysisError, OSError) as e:
            rows.append({"file": path, "ok": False, "error": str(e)})
            rc = 1
            continue
        rows.append({
            "file": path,
            "ok": True,
            "rows": r.n_rows,
            "rows6": r.n6_rows,
            "raw_lines": r.raw_lines,
            "skipped_lines": r.n_skipped,
            "block_rows": r.block_rows,
            "bytes_per_row": wire.ROWW_BYTES if r.weighted else wire.ROW_BYTES,
            "weighted": r.weighted,
            **({"evals": r.n_evals} if r.weighted else {}),
            # null = no ruleset given, nothing was checked
            "ruleset_match": True if fp is not None else None,
        })
        r.close()
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        for e in rows:
            if e["ok"]:
                w = (f" weighted rows ({e['evals']} evaluations)" if e["weighted"] else " rows")
                v6 = f" + {e['rows6']} v6 rows" if e["rows6"] else ""
                print(f"{e['file']}: {e['rows']}{w}{v6} from {e['raw_lines']} lines "
                      f"({e['skipped_lines']} skipped), block={e['block_rows']}"
                      + (", ruleset OK" if args.ruleset else ""))
            else:
                print(f"{e['file']}: INVALID — {e['error']}")
    return rc


def _cmd_synth(args: argparse.Namespace) -> int:
    import os

    os.makedirs(args.out_dir, exist_ok=True)
    cfg_text = synth.synth_config(
        n_acls=args.acls, rules_per_acl=args.rules, seed=args.seed,
        hostname=args.hostname, v6_fraction=args.v6_fraction,
    )
    cfg_path = f"{args.out_dir}/{args.hostname}.cfg"
    with open(cfg_path, "w", encoding="utf-8") as f:
        f.write(cfg_text)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, args.hostname)])
    log_path = f"{args.out_dir}/{args.hostname}.log"
    if args.flows > 0:
        # flow-repetition corpus: Zipf(--skew) draws from a bounded flow
        # pool, the feedstock coalescing compacts (the reference's lines)
        import random

        n6 = int(args.lines * args.v6_fraction) if packed.has_v6 else 0
        tuples = synth.synth_flow_tuples(packed, args.lines - n6, args.flows,
                                         skew=args.skew, seed=args.seed)
        lines = synth.render_syslog(packed, tuples, seed=args.seed)
        if n6:
            t6 = synth.synth_tuples6(packed, n6, seed=args.seed)
            lines += synth.render_syslog6(packed, t6, seed=args.seed + 1)
            random.Random(args.seed).shuffle(lines)
        with open(log_path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    else:
        synth.synth_syslog_file(packed, log_path, args.lines, seed=args.seed,
                                v6_fraction=args.v6_fraction)
    pack.save_packed(packed, f"{args.out_dir}/{args.hostname}")
    print(f"wrote {cfg_path}, {log_path}, {args.out_dir}/{args.hostname}.npz", file=sys.stderr)
    return 0


def _add_devprof_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--devprof-out", default=None, metavar="DIR",
                   help="device attribution capture: arm torch.profiler for a bounded window "
                        "of device steps after warmup, attribute the card's time to the "
                        "ra.* stages (ra.match/ra.talk/ra.counts/...) and write "
                        "DIR/devprof.json, also folded into totals.devprof and the metrics "
                        "JSONL (and serve's /metrics gauges); diff two captures with "
                        "`python -m ruleset_analysis_tpu_torch.tools.trace_diff` "
                        "(single-process runs only)")
    p.add_argument("--devprof-steps", type=int, default=DevprofConfig.steps, metavar="N",
                   help=f"device dispatches to capture (default {DevprofConfig.steps})")
    p.add_argument("--devprof-warmup", type=int, default=DevprofConfig.warmup, metavar="K",
                   help="dispatches to skip before the window opens, so kernel loads and "
                        f"allocator warmup stay out of it (default {DevprofConfig.warmup})")


def _add_blackbox_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--blackbox", choices=["on", "off"], default="on",
                   help="the always-on flight recorder: a ring of recent telemetry a "
                        "process, dumped on a typed abort, stall, crash or SIGQUIT and "
                        "merged into postmortem.json; a clean exit leaves nothing")
    p.add_argument("--blackbox-dir", default=None, metavar="DIR",
                   help="crash-forensics directory (default: a 'blackbox' dir beside the "
                        "checkpoint dir, or the serve dir); diagnose a bundle with `doctor`")


def _add_serve_parser(sub) -> None:
    p = sub.add_parser(
        "serve",
        help="always-on service mode: live syslog listeners feed time-windowed registers "
             "on the card; windowed/cumulative reports publish on every rotation to "
             "--serve-dir and a loopback JSON endpoint; SIGHUP (or a watched ruleset-file "
             "change) hot-reloads the rule tensors with counter migration",
    )
    p.add_argument("--ruleset", default=None, help="packed ruleset path prefix "
                   "(re-read on reload); exactly one of --ruleset/--tenants")
    p.add_argument("--tenants", default=None, metavar="MANIFEST",
                   help="the reference's multi-tenant mode (a JSON manifest of tenants); "
                        "the port does not serve it yet (exit 2)")
    p.add_argument("--listen", action="append", default=[], metavar="SPEC",
                   help="ingress (repeatable): udp:HOST:PORT, tcp:HOST:PORT "
                        "(newline-framed), tail:PATH (rotating-file tailer from the end) "
                        "or tail0:PATH (a spool read from offset 0, then followed)")
    p.add_argument("--window", required=True, metavar="W",
                   help="rotation cadence: a duration (900s, 15m, 24h) or lines:N "
                        "(deterministic line-count windows)")
    p.add_argument("--ring", type=int, default=8, metavar="N",
                   help="window epochs retained for merged views (default 8)")
    p.add_argument("--view", action="append", type=int, default=[], metavar="K",
                   help="also publish a merged view of the last K windows at every "
                        "rotation (repeatable; e.g. --view 24 --view 168 for 24h/7d at a "
                        "1h window)")
    p.add_argument("--serve-dir", required=True,
                   help="reports/endpoint/checkpoint directory")
    p.add_argument("--http", default="127.0.0.1:0", metavar="HOST:PORT",
                   help="JSON endpoint bind (port 0 = ephemeral, recorded in "
                        "serve-dir/endpoint.json; 'off' disables).  Paths: /report "
                        "/report/cumulative /report/window/<id> /report/merged/<k> /diff "
                        "/health /metrics /lineage")
    p.add_argument("--queue-lines", type=int, default=1 << 16, metavar="N",
                   help="listener queue capacity; lines past it DROP with an explicit "
                        "count and the window is published with a WindowIncomplete marker "
                        "(default 65536)")
    p.add_argument("--checkpoint-every-windows", type=int, default=1, metavar="N",
                   help="checkpoint the window ring every N rotations (0 = never; a "
                        "restarted serve --resume keeps its history)")
    p.add_argument("--checkpoint-dir", default=None, help="default: SERVE_DIR/ckpt")
    p.add_argument("--resume", action="store_true",
                   help="restore the window ring from --checkpoint-dir")
    p.add_argument("--reload-watch", action=argparse.BooleanOptionalAction, default=True,
                   help="poll the ruleset files and hot-reload on change (SIGHUP reloads "
                        "regardless)")
    p.add_argument("--reload-poll", type=float, default=2.0, metavar="SEC")
    p.add_argument("--max-windows", type=int, default=0, metavar="N",
                   help="stop after N rotations (0 = run forever)")
    p.add_argument("--stop-after", type=float, default=0.0, metavar="SEC",
                   help="soft wall-clock deadline (0 = none)")
    p.add_argument("--batch-size", type=int, default=1 << 16)
    p.add_argument("--cms-width", type=int, default=1 << 14)
    p.add_argument("--cms-depth", type=int, default=4)
    p.add_argument("--hll-p", type=int, default=8)
    p.add_argument("--register-budget-mb", type=int, default=4096, metavar="MB")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--stall-timeout", type=float, default=AnalysisConfig.stall_timeout_sec,
                   metavar="SEC")
    p.add_argument("--update-impl", choices=["scatter", "sorted"], default="scatter",
                   help="register-update formulation (see `run --update-impl`; the same "
                        "windows)")
    p.add_argument("--topk-every", type=int, default=1, metavar="N",
                   help="defer talker candidate selection to every Nth chunk (see `run "
                        "--topk-every`)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs every kernel's plain torch version")
    p.add_argument("--static-analysis", action="store_true",
                   help="run the static ruleset analyzer at start and on every hot reload "
                        "(unchanged ACLs reuse their verdicts): /report/static publishes "
                        "the verdict table, every window report's unused rules carry "
                        "evidence classes, and /metrics gains static_analysis_age_sec / "
                        "static_analysis_duration_sec")
    p.add_argument("--static-witness-budget", type=int, default=4096, metavar="N",
                   help="per-rule witness-grid cap for the serve analyzer (see `analyze "
                        "--witness-budget`)")
    p.add_argument("--wal", action="store_true",
                   help="durable ingest write-ahead log: every consumed line spools to "
                        "segmented, CRC'd records before window accounting, so serve "
                        "--resume after a hard kill replays the interrupted window over its "
                        "delivered lines; eviction/corruption losses are exactly counted")
    p.add_argument("--wal-dir", default="", help="WAL directory (default: SERVE_DIR/wal)")
    p.add_argument("--wal-segment-kb", type=int, default=1024, metavar="KB",
                   help="bytes per WAL segment before rolling (default 1024 KiB)")
    p.add_argument("--wal-budget-mb", type=int, default=64, metavar="MB",
                   help="total on-disk WAL budget; past it the oldest segment evicts with "
                        "its records counted as explicit drops at the next resume "
                        "(default 64)")
    p.add_argument("--lineage", choices=["on", "off"], default="on",
                   help="window provenance (default on): every published window carries a "
                        "sealed totals.lineage record (delivered WAL range, drop and "
                        "quarantine counts, publication path, reload generation, CRC), "
                        "appended to SERVE_DIR/lineage.jsonl and served at /lineage")
    p.add_argument("--slo", default="", metavar="SPEC",
                   help="SLO burn-rate alerting over published windows, e.g. "
                        "'p99_publish_ms<=500,drop_rate<=0.001': typed slo.breach / "
                        "slo.recovered events on fast(3)/slow(12)-window burn rates")
    p.add_argument("--epoch-store", default="", metavar="DIR",
                   help="the reference's durable epoch store (/report/range, "
                        "/report/last-hit); the port does not serve it yet (exit 2)")
    p.add_argument("--epoch-store-budget-mb", type=int, default=512, metavar="MB",
                   help="total on-disk epoch-store budget (needs --epoch-store)")
    p.add_argument("--trend-threshold", type=float, default=4.0, metavar="X",
                   help="per-rule traffic trend events in diff.json: a rule whose per-line "
                        "hit rate grows (shrinks) by more than Xx between consecutive "
                        "windows emits rule_burst (rule_quiet), with hysteresis (0 "
                        "disables; default 4.0)")
    p.add_argument("--mesh", choices=MESH_SHAPES, default="flat",
                   help="device mesh topology (parallel/mesh.py)")
    p.add_argument("--distributed", action="store_true",
                   help="the reference's multi-host serve; the port does not serve it yet "
                        "(exit 2)")
    p.add_argument("--dist-hosts", type=int, default=2, metavar="N",
                   help="ingest hosts to launch (default 2; needs --distributed)")
    p.add_argument("--dist-min-hosts", type=int, default=1, metavar="N",
                   help="host-tier ladder floor (default 1)")
    p.add_argument("--dist-max-hosts", type=int, default=0, metavar="N",
                   help="host-tier ladder ceiling (0 = --dist-hosts)")
    p.add_argument("--dist-workers", choices=["process", "thread"], default="process",
                   help="host worker isolation")
    p.add_argument("--dist-merge-bind", default="127.0.0.1:0", metavar="HOST:PORT",
                   help="rank-0 merge-plane bind for process workers")
    p.add_argument("--dist-merge-timeout", type=float, default=120.0, metavar="SEC",
                   help="max wait for a live host's epoch past a window's first arrival")
    p.add_argument("--dist-respawn", action="store_true",
                   help="respawn a dead host at the merge frontier")
    p.add_argument("--dist-lease-ttl", type=float, default=2.0, metavar="SEC",
                   help="supervisor-lease TTL (0 disables the lease plane)")
    p.add_argument("--dist-spool-dir", default="", metavar="DIR",
                   help="durable per-host epoch spool + lease root")
    p.add_argument("--dist-spool-budget-mb", type=int, default=64, metavar="MB",
                   help="per-host epoch-spool disk budget")
    _add_autoscale_flags(p)
    _add_blackbox_flags(p)
    p.add_argument("--fault-plan", default=None, metavar="SPEC",
                   help="chaos drills: see `run --fault-plan` (adds the listener.drop/"
                        "listener.stall/reload.midbatch, listener.bind.fail/"
                        "listener.accept.fail/serve.publish.fail/metrics.snapshot.fail and "
                        "lineage.append sites)")
    p.add_argument("--retry-policy", default="", metavar="SPEC",
                   help="retry/backoff overrides: see `run --retry-policy`")
    _add_devprof_flags(p)
    p.add_argument("--trace-out", default=None, metavar="DIR",
                   help="record listener/rotation/reload spans (see `run --trace-out`)")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="append queue/drop gauges + window events as JSON lines")
    p.add_argument("--metrics-every", type=float, default=10.0, metavar="SEC")
    p.set_defaults(fn=_cmd_serve)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ruleset_analysis_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("parse-acls", help="parse ASA configs into a packed ruleset")
    p.add_argument("configs", nargs="+")
    p.add_argument("--out", required=True, help="output path prefix")
    p.add_argument("--lenient", action="store_true",
                   help="skip (and count) unsupported access-list entries "
                        "instead of aborting")
    p.set_defaults(fn=_cmd_parse_acls)

    p = sub.add_parser("run", help="run the analysis over syslog")
    p.add_argument("--ruleset", required=True, help="packed ruleset path prefix")
    p.add_argument("--logs", nargs="+", required=True, help="syslog file(s), '-' for stdin")
    p.add_argument("--backend", choices=["oracle", "tpu"], default="tpu",
                   help="tpu (the reference's name): the device analysis on the card, "
                        "or on the CPU with --device cpu; oracle: the exact pure-Python "
                        "analysis (needs --acl-configs)")
    p.add_argument("--acl-configs", nargs="*", default=[],
                   help="original configs (oracle backend)")
    p.add_argument("--lenient", action="store_true",
                   help="parse --acl-configs leniently (see parse-acls --lenient)")
    p.add_argument("--batch-size", type=int, default=1 << 16)
    p.add_argument("--cms-width", type=int, default=1 << 14)
    p.add_argument("--cms-depth", type=int, default=4)
    p.add_argument("--hll-p", type=int, default=8)
    p.add_argument("--exact-counts", action=argparse.BooleanOptionalAction, default=True,
                   help="--no-exact-counts drops the exact per-rule count and reports "
                        "CMS estimates instead")
    p.add_argument("--register-budget-mb", type=int, default=4096, metavar="MB",
                   help="ceiling on device register memory (counts+CMS+HLL); "
                        "oversized geometries fail fast with a suggested --hll-p")
    p.add_argument("--topk-sample-shift", type=int, default=0, metavar="S",
                   help="select per-chunk talker candidates from every 2^S-th line "
                        "(the talker sketch still covers every line; 0 = full batch)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="CHUNKS",
                   help="snapshot (offset, registers) every N chunks")
    p.add_argument("--checkpoint-dir", default=None,
                   help="default: $RA_OUTPUT_DIR/ckpt")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-dir if a snapshot exists")
    p.add_argument("--report-every", type=int, default=0, metavar="CHUNKS",
                   help="print throughput to stderr every N chunks")
    p.add_argument("--packed-input", action="store_true",
                   help="require --logs to be .rawire wire files (see `convert`; wire "
                        "inputs are also auto-detected)")
    p.add_argument("--match-impl", choices=(*MATCH_IMPLS, "xla", "pallas"), default="scan",
                   help="scan (default; the reference's xla and pallas spell it too): the "
                        "first_match kernel, the counts in the register tail; fused: the "
                        "match_hist kernel (scan + count histograms)")
    p.add_argument("--experimental-match-impl", choices=["pallas_fused"], default=None,
                   metavar="IMPL",
                   help="the reference's opt-in fused kernel (pallas_fused = --match-impl "
                        "fused), overriding --match-impl")
    p.add_argument("--counts-impl", choices=COUNTS_IMPLS, default="scatter",
                   help="the reference's exact-counts formulation (matmul and reduce "
                        "need --match-impl scan); every one runs the port's one register "
                        "tail and gives the same report")
    p.add_argument("--update-impl", choices=UPDATE_IMPLS, default="scatter",
                   help="the reference's register-update formulation (sorted needs "
                        "--match-impl scan); every one runs the port's one register tail "
                        "and gives the same report")
    p.add_argument("--topk-every", type=int, default=1, metavar="N",
                   help="run talker candidate SELECTION every Nth chunk only (the "
                        "talker sketch still absorbs every line; 1 = every chunk)")
    p.add_argument("--layout", choices=LAYOUTS, default="flat",
                   help="flat steps lines in source order; stacked buckets lines by ACL on "
                        "the host and steps each grouped batch (not with --match-impl fused; "
                        "the same registers, talkers follow the grouping)")
    p.add_argument("--stacked-lane", type=int, default=0, metavar="N",
                   help="per-ACL lane width for --layout stacked (0 = batch size / ACLs)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs every kernel's plain torch version")
    p.add_argument("--mesh", choices=MESH_SHAPES, default="flat",
                   help="device mesh topology: flat = one data axis over every device; "
                        "hybrid = an outer (between-host) axis of --mesh-dcn groups times "
                        "an inner axis; batches shard and registers merge over both, the "
                        "report is the flat mesh's")
    p.add_argument("--mesh-dcn", type=int, default=0, metavar="N",
                   help="outer extent of --mesh hybrid; 0 = auto (the process count of a "
                        "--distributed job, else 2)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed job (NCCL on the card, gloo with --device "
                        "cpu); --logs are THIS process's input split (process 0 prints the "
                        "report)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="the job's rendezvous address, where process 0 listens (default: "
                        "the env:// variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--elastic", action="store_true",
                   help="supervise the distributed job elastically: when a peer dies the "
                        "survivors re-form at the surviving world size and resume from the "
                        "shared epoch checkpoint.  --logs becomes the FULL shard list (the "
                        "same on every launcher); needs --elastic-dir, --checkpoint-every "
                        "and --json")
    p.add_argument("--elastic-dir", default=None, metavar="DIR",
                   help="shared rendezvous + epoch-checkpoint directory for --elastic (must "
                        "be visible to every launcher)")
    p.add_argument("--max-reforms", type=int, default=2, metavar="N",
                   help="abort (exit 7) after N automatic re-formations (the Hadoop "
                        "max-task-retries analog; default 2)")
    _add_autoscale_flags(p)
    p.add_argument("--native-parse", action=argparse.BooleanOptionalAction, default=None,
                   help="use the C++ host parser (default: when it builds and the "
                        "logs are text files)")
    p.add_argument("--prefetch-depth", type=int, default=AnalysisConfig.prefetch_depth,
                   metavar="K",
                   help="parse/pack/copy up to K batches ahead of the device step on "
                        "a background producer (identical reports; 0 = synchronous)")
    p.add_argument("--feed-workers", type=int, default=0, metavar="N",
                   help="parse with N workers over file shards (multi-core hosts; implies "
                        "the native parser; 0/1 = off)")
    p.add_argument("--feed-mode", choices=FEED_MODES, default="process",
                   help="worker kind for --feed-workers: separate processes packing into "
                        "shared memory, in-process threads around the GIL-releasing native "
                        "parser, or 'ring': one shared-memory ring per device with a "
                        "partitioned worker pool, each device's part copied to the card "
                        "straight from its ring (identical reports across the three modes)")
    p.add_argument("--coalesce", choices=["off", "on", "auto"], default="off",
                   help="pre-aggregate each batch's duplicate flow tuples into "
                        "(unique row, weight) pairs before the device step "
                        "(identical report; not with --match-impl fused)")
    p.add_argument("--fault-plan", default=None, metavar="SPEC",
                   help="arm deterministic fault injection (chaos drills): site@N[:k],...,"
                        "seed=S fires each site on its Nth hit (k consecutive hits with :k), "
                        "or @FILE holding the spec; see runtime/faults.py SITES")
    p.add_argument("--retry-policy", default="", metavar="SPEC",
                   help="override the retry engine: site=attempts[/base_sec],...,seed=S, "
                        "or 'off' for one attempt a site; empty = the per-site defaults")
    p.add_argument("--trace-out", default=None, metavar="DIR",
                   help="record pipeline spans and fault/retry instants in per-process "
                        "shards in DIR, merged into DIR/trace.json at exit (Perfetto / "
                        "chrome://tracing); spawned workers inherit it via RA_TRACE_DIR")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="append machine-readable run telemetry (JSON lines: lines/s, prefetch "
                        "queue depth and wait times, feeder occupancy, checkpoint bytes and "
                        "seconds, retry counters, RSS, the card's memory) to FILE")
    p.add_argument("--metrics-every", type=float, default=10.0, metavar="SEC",
                   help="snapshot cadence of --metrics-out (default 10s)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a whole-run torch.profiler trace here (CPU ops, and the card's "
                        "kernels on a CUDA run; a Chrome trace for Perfetto or "
                        "chrome://tracing)")
    _add_devprof_flags(p)
    _add_blackbox_flags(p)
    p.add_argument("--stall-timeout", type=float, default=AnalysisConfig.stall_timeout_sec,
                   metavar="SEC",
                   help="fail when the prefetch producer hands over no batch for SEC "
                        "seconds")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--static-analysis", action="store_true",
                   help="join static reachability verdicts into the report after the run: "
                        "unused rules split into provably dead (safe to delete) and "
                        "traffic-dependent classes, and a rule with hits but a dead verdict is "
                        "an error (see `analyze`; runs on --device)")
    p.add_argument("--static-witness-budget", type=int, default=4096, metavar="N",
                   help="per-rule witness-grid cap for --static-analysis")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None, help="write the report here instead of stdout")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("doctor",
                       help="diagnose a failed run: postmortem.json and exit code -> ranked "
                            "causes with next actions")
    p.add_argument("bundle", help="postmortem.json, or the blackbox directory holding one")
    p.add_argument("--exit-code", type=int, default=None, metavar="RC",
                   help="the run's exit code (default: the one recorded in the bundle)")
    p.add_argument("--lineage", default=None, metavar="PATH",
                   help="a serve dir's lineage.jsonl to join with the bundle (default: one "
                        "found beside the bundle or in its parent directory); the diagnosis "
                        "then names the last fully published window and the first missing or "
                        "incomplete one")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=_cmd_doctor)

    p = sub.add_parser("analyze",
                       help="static ruleset analysis (no traffic): per-rule first-match "
                            "reachability verdicts; shadowed, redundant and conflict rules are "
                            "provably dead")
    p.add_argument("--ruleset", required=True, help="packed ruleset path prefix")
    p.add_argument("--tile", type=int, default=None, metavar="T",
                   help="pair-tile edge (default 512): each ACL's O(R^2) pair grid is walked "
                        "in [T, T] tiles")
    p.add_argument("--witness-budget", type=int, default=4096, metavar="N",
                   help="per-rule cap on witness-grid enumeration; past it a rule stays "
                        "partially-masked and uncertified, never dead")
    p.add_argument("--fault-plan", default=None, metavar="SPEC",
                   help="arm a fault plan around the analysis (site@N[:k],...,seed=S, or "
                        "@FILE); its site is analyze.tile")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs every kernel's plain torch version")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None, help="write the analysis here instead of stdout")
    p.set_defaults(fn=_cmd_analyze)

    _add_serve_parser(sub)

    p = sub.add_parser("convert", help="pre-tokenize text syslog into a .rawire wire file")
    p.add_argument("--ruleset", required=True, help="packed ruleset path prefix")
    p.add_argument("--logs", nargs="+", required=True, help="text syslog file(s)")
    p.add_argument("--out", required=True, help="output .rawire path")
    p.add_argument("--native-parse", action=argparse.BooleanOptionalAction, default=None,
                   help="use the C++ parser for the one-time conversion (default: "
                        "when it builds)")
    p.add_argument("--block-rows", type=int, default=1 << 16, metavar="N",
                   help="rows per payload block; match the run --batch-size for the "
                        "zero-copy mmap read path (default 65536)")
    p.add_argument("--feed-workers", type=int, default=0, metavar="N",
                   help="parse with N worker processes (a multi-core one-time conversion; "
                        "the output is byte-identical; 0/1 = off)")
    p.add_argument("--coalesce", action="store_true",
                   help="write the weighted v3 format: per-batch duplicate flow tuples "
                        "stored once with a repetition count (runs on the default "
                        "--match-impl scan, not fused)")
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="convert fleet: shard the corpus by exact-raw-line descriptors "
                        "across N worker processes, each writing one pre-coalesced RAWIREv3 "
                        "shard; --out becomes a merge manifest that `run` reads as one "
                        "corpus (the same for any N; implies the weighted format; 0 = one "
                        "file)")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("wire-info", help="inspect .rawire wire-file headers")
    p.add_argument("files", nargs="+", help=".rawire file(s) or convert-fleet manifests")
    p.add_argument("--ruleset", default=None,
                   help="packed ruleset prefix to validate the fingerprint against")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_wire_info)

    p = sub.add_parser("diff-reports",
                       help="compare two `run --json` reports: stable-unused deletion "
                            "candidates, newly used and unused rules, top hit movers")
    p.add_argument("old", help="the earlier report (run --json output)")
    p.add_argument("new", help="the later report")
    p.add_argument("--top", type=int, default=10, help="hit movers to show")
    p.add_argument("--expect-window", default=None, metavar="W",
                   help="require both reports to be serve window reports of exactly this "
                        "window (lines:N or a duration like 24h); a mismatch is a typed "
                        "refusal, not a misleading diff")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_diff_reports)

    p = sub.add_parser("synth", help="generate a synthetic config, syslog and packed ruleset")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--acls", type=int, default=4)
    p.add_argument("--rules", type=int, default=32)
    p.add_argument("--lines", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hostname", default="fw1")
    p.add_argument("--v6-fraction", type=float, default=0.0,
                   help="fraction of ACEs (and log lines) spelled IPv6: a unified "
                        "dual-stack config and a mixed corpus")
    p.add_argument("--flows", type=int, default=0, metavar="M",
                   help="draw lines from a pool of M distinct flows with Zipf(--skew) "
                        "repetition (0 = independent lines)")
    p.add_argument("--skew", type=float, default=1.0, metavar="S",
                   help="Zipf exponent for --flows (0 = uniform; default 1.0)")
    p.set_defaults(fn=_cmd_synth)
    return ap


def _finalize_obs() -> None:
    """Stop the metrics plane (its ``final`` snapshot) and merge the trace
    shards, then disarm the devprof capture, typed aborts included; three
    None-checks when none is armed."""
    from .runtime import devprof, obs

    try:
        cap = devprof.active_capture()
        if cap is not None and getattr(cap, "json_path", None):
            print(f"devprof: {cap.json_path} (per-stage attribution; diff two captures with "
                  "python -m ruleset_analysis_tpu_torch.tools.trace_diff)", file=sys.stderr)
    except Exception as e:
        print(f"warning: devprof summary hint failed: {e}", file=sys.stderr)
    try:
        merged = obs.shutdown()
    except Exception as e:  # a broken merge must not mask the run's code
        print(f"warning: trace merge failed: {e}", file=sys.stderr)
        merged = None
    finally:
        # after obs.shutdown: the final snapshot still reads the devprof
        # and device_mem samplers; this stops a dangling window (the
        # typed-abort path) without parsing it
        try:
            devprof.shutdown()
        except Exception as e:
            print(f"warning: devprof shutdown failed: {e}", file=sys.stderr)
    if merged:
        print(f"trace: {merged} (open in Perfetto or chrome://tracing)", file=sys.stderr)


def _finalize_blackbox() -> None:
    """Dump and merge the flight recorder after an abort, prune after a
    clean exit, then disarm it (its hooks go with it)."""
    from .runtime import flightrec

    try:
        pm = flightrec.finalize()
    except Exception as e:  # forensics must never mask the run's code
        print(f"warning: postmortem merge failed: {e}", file=sys.stderr)
        pm = None
    finally:
        flightrec.disarm()
    if pm:
        print(f"postmortem: {pm} (diagnose with `doctor {pm}`)", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    from .runtime import flightrec

    try:
        return args.fn(args)
    except errors.AnalysisError as e:
        # the failure class decides the code (errors.exit_code_for)
        print(f"error: {e}", file=sys.stderr)
        rc = errors.exit_code_for(e)
        flightrec.note_abort(e, rc)
        return rc
    except (aclparse.AclParseError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    finally:
        _finalize_obs()
        # after obs: an unhandled exception is still on sys.exc_info here,
        # so finalize sees it
        _finalize_blackbox()
        # last, as in the reference: the final snapshot and a dump both
        # read the card's memory
        from .runtime import obs

        obs.unregister_sampler("device_mem")


if __name__ == "__main__":
    raise SystemExit(main())
