"""Per-stage delta table between two devprof captures.

    python -m ruleset_analysis_tpu_torch.tools.trace_diff A B [--json|--csv]

A and B are ``devprof.json`` files that ``run --devprof-out`` wrote, or
the directories holding them.  Run the same workload twice with one knob
changed (``--match-impl scan`` against ``fused``, flat against stacked)
and diff the captures:

- **per-stage delta table**: device time per ``ra.*`` stage, normalized
  per profiled step so captures of different window lengths compare,
  with absolute and relative deltas;
- **fusion-boundary change detection**: each capture records, per
  program, the stages of every hand kernel it ran (``fusions``, the
  kernel's ``stages.KERNEL_STAGES`` signature: a hand kernel is the
  port's fusion boundary).  A signature on one side only means the two
  runs drew different boundaries: the scan route's ``first_match_kernel``
  (``ra.match``) against the fused route's ``match_hist_kernel``
  (``ra.match`` + ``ra.counts``).

The tables, the CSV and the JSON are the reference's
``tools/trace_diff.py``'s, which reads the same summary keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_capture(path: str) -> dict:
    """One devprof.json (or a directory containing one) -> summary dict."""
    if os.path.isdir(path):
        path = os.path.join(path, "devprof.json")
    with open(path, "r", encoding="utf-8") as f:
        cap = json.load(f)
    if "stages" not in cap or "steps_profiled" not in cap:
        raise ValueError(f"{path!r} is not a devprof capture summary")
    cap["_path"] = path
    return cap


def _per_step(cap: dict, stage: str) -> float:
    steps = max(1, cap.get("steps_profiled", 1))
    return cap["stages"].get(stage, {}).get("device_us", 0.0) / steps


def _fusion_signatures(cap: dict) -> dict[str, set[tuple[str, ...]]]:
    """program label -> set of multi-instruction stage signatures.

    Single-stage fusions are kept too: a stage that WAS one fusion and
    became three is a boundary change even if no signature crosses
    stages.  Signatures count multiplicity via a trailing index so
    "two ra.counts fusions" differs from "one".
    """
    out: dict[str, set[tuple[str, ...]]] = {}
    for label, prog in (cap.get("programs") or {}).items():
        sigs: dict[tuple[str, ...], int] = {}
        for f in prog.get("fusions", []):
            key = tuple(f.get("stages") or ("(unscoped)",))
            sigs[key] = sigs.get(key, 0) + 1
        out[label] = {(*k, f"x{n}") for k, n in sigs.items()}
    return out


def diff_captures(a: dict, b: dict, label_a: str = "A", label_b: str = "B") -> dict:
    """Machine-readable per-stage delta + fusion-boundary changes."""
    stages = sorted(
        set(a["stages"]) | set(b["stages"]),
        key=lambda s: -(a["stages"].get(s, {}).get("device_us", 0.0)
                        + b["stages"].get(s, {}).get("device_us", 0.0)),
    )
    rows = []
    for s in stages:
        ua, ub = _per_step(a, s), _per_step(b, s)
        rows.append({
            "stage": s,
            f"{label_a}_us_per_step": round(ua, 1),
            f"{label_b}_us_per_step": round(ub, 1),
            "delta_us_per_step": round(ub - ua, 1),
            "ratio": round(ub / ua, 4) if ua > 0 else None,
            f"{label_a}_pct": a["stages"].get(s, {}).get("pct", 0.0),
            f"{label_b}_pct": b["stages"].get(s, {}).get("pct", 0.0),
        })
    tot_a = a.get("device_us_total", 0.0) / max(1, a.get("steps_profiled", 1))
    tot_b = b.get("device_us_total", 0.0) / max(1, b.get("steps_profiled", 1))
    sig_a, sig_b = _fusion_signatures(a), _fusion_signatures(b)
    boundary = {}
    for label in sorted(set(sig_a) | set(sig_b)):
        only_a = sorted(sig_a.get(label, set()) - sig_b.get(label, set()))
        only_b = sorted(sig_b.get(label, set()) - sig_a.get(label, set()))
        if only_a or only_b:
            boundary[label] = {
                f"only_{label_a}": [list(s) for s in only_a],
                f"only_{label_b}": [list(s) for s in only_b],
            }
    return {
        label_a: {
            "path": a.get("_path"),
            "label": a.get("label", ""),
            "steps_profiled": a.get("steps_profiled"),
            "backend": a.get("backend"),
            "attributed_frac": a.get("attributed_frac"),
            "step_us": round(tot_a, 1),
        },
        label_b: {
            "path": b.get("_path"),
            "label": b.get("label", ""),
            "steps_profiled": b.get("steps_profiled"),
            "backend": b.get("backend"),
            "attributed_frac": b.get("attributed_frac"),
            "step_us": round(tot_b, 1),
        },
        "step_ratio": round(tot_b / tot_a, 4) if tot_a > 0 else None,
        "stages": rows,
        "fusion_boundary_changes": boundary,
        "fusion_boundaries_changed": bool(boundary),
    }


def render(d: dict, label_a: str = "A", label_b: str = "B") -> str:
    ia, ib = d[label_a], d[label_b]

    def tag(info, fallback):
        return info.get("label") or os.path.basename(
            os.path.dirname(info.get("path") or "") or fallback
        ) or fallback

    na, nb = tag(ia, label_a), tag(ib, label_b)
    out = [
        f"== trace diff: {na} ({ia['backend']}, {ia['steps_profiled']} steps, "
        f"{100 * (ia['attributed_frac'] or 0):.1f}% attributed) vs "
        f"{nb} ({ib['backend']}, {ib['steps_profiled']} steps, "
        f"{100 * (ib['attributed_frac'] or 0):.1f}% attributed) ==",
        f"  step time: {ia['step_us']:.1f} -> {ib['step_us']:.1f} us/step "
        f"({d['step_ratio']}x)" if d["step_ratio"] is not None else
        f"  step time: {ia['step_us']:.1f} -> {ib['step_us']:.1f} us/step",
        f"  {'stage':<12} {na[:14]:>14} {nb[:14]:>14} {'delta':>12} {'ratio':>8}",
    ]
    ka, kb = f"{label_a}_us_per_step", f"{label_b}_us_per_step"
    for r in d["stages"]:
        ratio = f"{r['ratio']:.3f}x" if r["ratio"] is not None else "new"
        out.append(
            f"  {r['stage']:<12} {r[ka]:>12.1f}us {r[kb]:>12.1f}us "
            f"{r['delta_us_per_step']:>+10.1f}us {ratio:>8}"
        )
    bc = d["fusion_boundary_changes"]
    if bc:
        out.append("  fusion boundaries CHANGED:")
        for label, ch in bc.items():
            for side, sigs in ch.items():
                for s in sigs:
                    out.append(f"    {label}: {side}: {'+'.join(s)}")
    else:
        out.append("  fusion boundaries: unchanged")
    return "\n".join(out)


def render_csv(d: dict, label_a: str = "A", label_b: str = "B") -> str:
    """Spreadsheet-ready stage table (one header + one row per stage,
    plus a ``(step)`` totals row).  Fusion-boundary changes are not
    tabular — use ``--json`` for those; the boundary VERDICT rides the
    totals row's last column so a CSV consumer still sees it.
    """
    import csv
    import io

    ka, kb = f"{label_a}_us_per_step", f"{label_b}_us_per_step"
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow([
        "stage", ka, kb, "delta_us_per_step", "ratio",
        f"{label_a}_pct", f"{label_b}_pct", "fusion_boundaries_changed",
    ])
    for r in d["stages"]:
        w.writerow([
            r["stage"], r[ka], r[kb], r["delta_us_per_step"],
            "" if r["ratio"] is None else r["ratio"],
            r[f"{label_a}_pct"], r[f"{label_b}_pct"], "",
        ])
    w.writerow([
        "(step)", d[label_a]["step_us"], d[label_b]["step_us"],
        round(d[label_b]["step_us"] - d[label_a]["step_us"], 1),
        "" if d["step_ratio"] is None else d["step_ratio"],
        100.0, 100.0, d["fusion_boundaries_changed"],
    ])
    return buf.getvalue()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="per-stage delta table between two devprof captures"
    )
    ap.add_argument("old", help="baseline capture (devprof.json or its dir)")
    ap.add_argument("new", help="comparison capture")
    fmt = ap.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true", help="machine output")
    fmt.add_argument("--csv", action="store_true",
                     help="stage table as CSV (README: reading a trace diff)")
    args = ap.parse_args(argv)
    try:
        a, b = load_capture(args.old), load_capture(args.new)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    d = diff_captures(a, b)
    if args.json:
        print(json.dumps(d, indent=2))
    elif args.csv:
        print(render_csv(d), end="")
    else:
        print(render(d))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
