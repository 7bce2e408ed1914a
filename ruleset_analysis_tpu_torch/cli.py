"""Command-line interface of the port: ``synth``, ``parse-acls`` and ``run``.

  python -m ruleset_analysis_tpu_torch.cli synth --out-dir DIR [...]
  python -m ruleset_analysis_tpu_torch.cli parse-acls CONFIG [...] --out PREFIX
  python -m ruleset_analysis_tpu_torch.cli run --ruleset PREFIX --logs FILE \\
      [--match-impl {fused,scan}] [--device {cuda,cpu}] [--json] [--out FILE]

``run`` runs on the CUDA device unless ``--device cpu`` is given; with no
card it exits 1 with a message.  Packed rulesets are the reference's
format, so either package's ``parse-acls`` output loads here.
"""

from __future__ import annotations

import argparse
import sys

from . import errors
from .config import AnalysisConfig, MATCH_IMPLS
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
    print(
        f"packed {packed.rules.shape[0]} ACE rows, {packed.n_rules} rule keys, "
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


def _cmd_run(args: argparse.Namespace) -> int:
    from .runtime.stream import run_stream, run_stream_file

    try:
        cfg = AnalysisConfig(
            batch_size=args.batch_size,
            match_impl=args.match_impl,
            device=args.device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    packed = pack.load_packed(args.ruleset)
    if "-" in args.logs:
        rep = run_stream(packed, _iter_log_lines(args.logs), cfg, topk=args.topk)
    else:
        rep = run_stream_file(packed, args.logs, cfg, topk=args.topk)
    payload = rep.to_json() if args.json else rep.to_text()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload + "\n")
    else:
        print(payload)
    return 0


def _cmd_synth(args: argparse.Namespace) -> int:
    import os

    os.makedirs(args.out_dir, exist_ok=True)
    cfg_text = synth.synth_config(
        n_acls=args.acls, rules_per_acl=args.rules, seed=args.seed,
        hostname=args.hostname,
    )
    cfg_path = f"{args.out_dir}/{args.hostname}.cfg"
    with open(cfg_path, "w", encoding="utf-8") as f:
        f.write(cfg_text)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, args.hostname)])
    log_path = f"{args.out_dir}/{args.hostname}.log"
    synth.synth_syslog_file(packed, log_path, args.lines, seed=args.seed)
    pack.save_packed(packed, f"{args.out_dir}/{args.hostname}")
    print(f"wrote {cfg_path}, {log_path}, {args.out_dir}/{args.hostname}.npz", file=sys.stderr)
    return 0


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
    p.add_argument("--batch-size", type=int, default=1 << 16)
    p.add_argument("--match-impl", choices=MATCH_IMPLS, default="fused",
                   help="fused: match_hist kernel (scan + count histograms); "
                        "scan: first_match kernel + scatter counts")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs every kernel's plain torch version")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None, help="write the report here instead of stdout")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("synth", help="generate a synthetic config, syslog and packed ruleset")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--acls", type=int, default=4)
    p.add_argument("--rules", type=int, default=32)
    p.add_argument("--lines", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hostname", default="fw1")
    p.set_defaults(fn=_cmd_synth)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (aclparse.AclParseError, errors.AnalysisError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
