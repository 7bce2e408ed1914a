"""One `chip_smoke.py` phase of several checkouts of the PyTorch port, in turns, on one card.

    python3 tools/torch_phase_turns.py --trees OLD NEW [--phase phase_reg_tail] \
        [--turns 2] [--grep "kernel "] [--script chip_smoke.py]

Runs ``chip_smoke.<phase>(device, card)`` from each checkout's own
``chip_smoke.py`` (or, with ``--script PATH``, from that one file against
each checkout's package), each in a fresh process from that checkout's
root (so each builds and loads its own kernels), in turns: OLD, NEW, NEW, OLD, ...
for ``--turns`` rounds.  The phase checks its kernels against their plain
versions as it does in ``chip_smoke.py`` and prints its timings; this
prints each run's lines that contain ``--grep`` (default ``"kernel "``),
under a header naming the checkout and the turn, and the card's name and
power limit once.  A phase that fails stops the script with its output.
Compare two versions only within one such call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

#: the phase runs in a child from the checkout's root (its package first
#: on the path): the card and its name, then the phase of the script
CHILD = (
    "import importlib.util, sys, torch; sys.path.insert(0, '.'); "
    "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[2]); "
    "c = importlib.util.module_from_spec(spec); spec.loader.exec_module(c); "
    "dev = torch.device('cuda', 0); torch.cuda.set_device(dev); "
    "getattr(c, sys.argv[1])(dev, c.nvidia_smi())"
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkout roots, two or more")
    ap.add_argument("--phase", default="phase_reg_tail",
                    help="a chip_smoke.py function taking (device, card)")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--grep", default="kernel ")
    ap.add_argument("--script", default=None,
                    help="the chip_smoke.py whose phase every checkout runs (default: each "
                         "checkout's own), for a phase an older checkout lacks")
    args = ap.parse_args(argv)
    script = os.path.abspath(args.script) if args.script else "chip_smoke.py"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    for turn in range(args.turns):
        order = args.trees if turn % 2 == 0 else args.trees[::-1]
        for tree in order:
            r = subprocess.run([sys.executable, "-c", CHILD, args.phase, script], cwd=tree,
                               capture_output=True, text=True)
            print(f"== {tree}, turn {turn}", flush=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, flush=True)
                return r.returncode
            for line in r.stdout.splitlines():
                if args.grep in line:
                    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
