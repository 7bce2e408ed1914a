"""Device time by ``ra.*`` stage from a ``torch.profiler`` Chrome trace.

    python -m ruleset_analysis_tpu_torch.tools.trace_attrib [TRACE ...]

Defaults to every ``*.pt.trace.json`` under ``profiles/``.  A trace is
what ``run --profile-dir DIR`` writes (``DIR/profile-<pid>.pt.trace.json``)
or a capture window's (``--devprof-out DIR``: ``DIR/torch-trace/``).  For
each process of the trace it prints the device time by the outermost
``ra.*`` stage range around each event's launch, falling back to the raw
event name where no stage range holds it (host work between dispatches,
the loop's copies).  A device event is a kernel, copy or memset record
on CUDA, a top-level CPU op on the CPU; the classifier is the capture's
own (``runtime/devprof.attribute_events``), so the two never disagree
about the stage of an op, though this tool counts events outside the
program ranges too.  It also flags ``ra.*`` range names that are not in
the registered taxonomy (``stages.STAGES``).

The counterpart of the reference's ``tools/trace_attrib.py``, which reads
``jax.profiler`` traces.
"""

from __future__ import annotations

import collections
import glob
import json
import sys

from ..runtime.devprof import attribute_events
from ..stages import SCOPE_RE, STAGES


def load_events(path: str) -> list[dict]:
    """Chrome trace events (the object form, or the bare event array)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        return data.get("traceEvents", [])
    return data


def attribute(path: str, top: int = 20) -> dict:
    """Per-(process, label) device time; label = ra.* stage or raw event name."""
    ev = load_events(path)
    names = {
        e["pid"]: e["args"].get("name", "")
        for e in ev
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and isinstance(e.get("args"), dict)
    }
    tot: dict = collections.defaultdict(float)
    cnt: collections.Counter = collections.Counter()
    scoped_us = total_us = 0.0
    for r in attribute_events(ev, programs=None):
        label = r["stage"] if r["stage"] is not None else r["name"][:90]
        key = (names.get(r["pid"], str(r["pid"])), label)
        tot[key] += r["dur"]
        cnt[key] += 1
        total_us += r["dur"]
        if r["stage"] is not None:
            scoped_us += r["dur"]
    unregistered = {
        tok
        for e in ev
        if e.get("cat") == "user_annotation"
        for tok in SCOPE_RE.findall(e.get("name", ""))
        if tok not in STAGES
    }
    return {
        "path": path,
        "events": len(ev),
        "total_us": total_us,
        "scoped_us": scoped_us,
        "unregistered_stages": sorted(unregistered),
        "rows": [
            {"process": proc, "label": name, "us": d, "count": cnt[(proc, name)]}
            for (proc, name), d in sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        ],
    }


def render(a: dict) -> str:
    out = [f"== {a['path']} ({a['events']} events) =="]
    if a["total_us"]:
        out.append(
            f"  {100.0 * a['scoped_us'] / a['total_us']:.1f}% of device time "
            "carries a named ra.* stage"
            if a["scoped_us"]
            else "  no ra.* stage ranges found (a trace taken with no profiler of "
            "the port live); showing raw event names"
        )
    if a.get("unregistered_stages"):
        out.append(
            "  WARNING: ra.* ranges not in the registered taxonomy "
            f"(stages.py): {', '.join(a['unregistered_stages'])}"
        )
    for r in a["rows"]:
        out.append(
            f"{r['us'] / 1e3:10.1f} ms  x{r['count']:>6}  [{r['process']}] {r['label']}"
        )
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = argv or sorted(glob.glob("profiles/**/*.pt.trace.json", recursive=True))
    if not paths:
        print("no traces found under profiles/", file=sys.stderr)
        return 1
    rc = 0
    for p in paths:
        try:
            print(render(attribute(p)))
            print()
        except (OSError, ValueError) as e:
            print(f"error: unreadable trace {p!r}: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
