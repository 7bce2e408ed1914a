"""Alternating `run` pairs of two checkouts of the PyTorch port, on one card.

    python3 tools/torch_run_pairs.py --trees OLD NEW [--rounds 4] [--work DIR] \
        [--lines N] [--device cuda|cpu]

Builds two corpora once (``synth --seed 0``), at ``chip_smoke.py``'s
sizes: the 16x256 v4 ruleset with 2^21 text lines of Zipf(1.0)-repeated
flows over a pool of 2^16 (``synth --flows``; the ingest phase's shape),
and the dual-stack 16x256 ruleset (``synth --v6-fraction 0.3``) with 2^20 lines, converted
to a plain v2 and a weighted v3 ``.rawire`` (the dual-stack phase's
inputs).  Then it runs ``ruleset_analysis_tpu_torch.cli run`` over each
input in both checkouts in turns OLD, NEW, NEW, OLD per round, each run
in a fresh process from its checkout's root, with one untimed run per
checkout first (it builds that checkout's kernels).  It prints one line
per run (``sustained_lines_per_sec``, ``elapsed_sec``, the ingest
counters of ``totals``) and, per input and checkout, the median and
range, with the card's name and power limit.  Both checkouts read the
same files: the formats are shared.  ``--lines`` scales both corpora
(the v4 one is twice it).  Its files land in ``--work`` (default
``build/pairs/``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: input name -> (corpus, file in the corpus's directory, extra `run`
#: flags); batch 2^18, as in chip_smoke.py's text and dual-stack runs
INPUTS = {
    "16x256 text, native, prefetch 2": ("v4", "fw1.log", ("--match-impl", "fused",
                                                          "--native-parse", "--prefetch-depth",
                                                          "2")),
    "dual-stack text, native, prefetch 2": ("dual", "fw1.log", ("--match-impl", "fused",
                                                                "--native-parse",
                                                                "--prefetch-depth", "2")),
    "dual-stack wire v2": ("dual", "fw1.rawire", ("--match-impl", "fused")),
    "dual-stack weighted v3, scan": ("dual", "fw1-w.rawire", ("--match-impl", "scan")),
}
BATCH = 1 << 18


def cli(tree: str, *args: str) -> None:
    subprocess.run([sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", *args], cwd=tree,
                   check=True, stdout=subprocess.DEVNULL)


def make_inputs(tree: str, work: str, lines: int) -> dict:
    """Each corpus's directory and packed ruleset prefix, built once."""
    corpora = {"v4": ("--lines", str(2 * lines), "--flows", str(1 << 16), "--skew", "1.0",
                      "--seed", "0"),
               "dual": ("--lines", str(lines), "--seed", "0", "--v6-fraction", "0.3")}
    out = {}
    for name, flags in corpora.items():
        d = os.path.join(work, name)
        prefix = os.path.join(d, "parsed")
        out[name] = (d, prefix)
        if os.path.exists(prefix + ".json"):
            continue
        cli(tree, "synth", "--out-dir", d, "--acls", "16", "--rules", "256", *flags)
        cli(tree, "parse-acls", os.path.join(d, "fw1.cfg"), "--out", prefix)
        if name == "dual":
            for f, extra in (("fw1.rawire", ()), ("fw1-w.rawire", ("--coalesce",))):
                cli(tree, "convert", "--ruleset", prefix, "--logs", os.path.join(d, "fw1.log"),
                    "--out", os.path.join(d, f), "--native-parse", "--block-rows", str(BATCH),
                    *extra)
    return out


def run_once(tree: str, prefix: str, path: str, extra, out: str, device: str) -> dict:
    cli(tree, "run", "--ruleset", prefix, "--logs", path, "--batch-size", str(BATCH), "--json",
        "--out", out, "--device", device, *extra)
    with open(out, encoding="utf-8") as fh:
        return json.load(fh)["totals"]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "nvidia-smi not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "pairs"))
    ap.add_argument("--lines", type=int, default=1 << 20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    args.work = os.path.abspath(args.work)
    os.makedirs(args.work, exist_ok=True)
    corpora = make_inputs(trees[1], args.work, args.lines)
    smi = card()
    print(f"card: {smi}", flush=True)

    def run(tree, name, out):
        corpus, f, extra = INPUTS[name]
        d, prefix = corpora[corpus]
        return run_once(tree, prefix, os.path.join(d, f), extra, os.path.join(args.work, out),
                        args.device)

    for t in trees:  # untimed: builds the checkout's kernels
        run(t, "dual-stack weighted v3, scan", "w.json")
    rates: dict = {(n, t): [] for n in INPUTS for t in ("OLD", "NEW")}
    order = [("OLD", trees[0]), ("NEW", trees[1]), ("NEW", trees[1]), ("OLD", trees[0])]
    for r in range(args.rounds):
        for label, tree in order:
            for name in INPUTS:
                tot = run(tree, name, "r.json")
                rates[(name, label)].append(tot["sustained_lines_per_sec"])
                ingest = tot.get("ingest") or {}
                print(f"round {r} {label} {name}: sustained_lines_per_sec "
                      f"{tot['sustained_lines_per_sec']}, elapsed_sec {tot['elapsed_sec']}, "
                      f"chunks {tot['chunks']}, ingest {json.dumps(ingest, sort_keys=True)}",
                      flush=True)
    for name in INPUTS:
        for label in ("OLD", "NEW"):
            v = rates[(name, label)]
            print(f"summary {name} {label}: median {statistics.median(v)}, min {min(v)}, "
                  f"max {max(v)}, n {len(v)}; on {smi}")
    print(json.dumps({"pairs": {f"{n} | {lab}": v for (n, lab), v in rates.items()},
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
