"""Self-validating step timing: windows closed by a fetch of the counts.

A timed window of device steps closes with a host fetch of the count
registers (``pipeline.counts_total``).  The fetch cannot return before
every step in the window has executed, so it is also the window's
synchronization with the card, and it is independent evidence that the
work happened: each valid line adds exactly one count.
"""

from __future__ import annotations

import time


def timed_validated_steps(step, state, rules, feeds, valid_per_feed, iters):
    """Run ``iters`` steps over cycling resident feeds, timed and validated.

    Returns ``(state, dt, delta, expect)``: the new state, the wall time
    of the window (closed by the counts fetch), the measured count
    delta, and the expected one (the valid lines stepped).  Callers
    treat ``delta != expect`` as a failed measurement.
    """
    from ..models import pipeline

    base = pipeline.counts_total(state)
    t0 = time.perf_counter()
    for i in range(iters):
        state, _out = step(state, rules, feeds[i % len(feeds)])
    total = pipeline.counts_total(state)  # the sync and the evidence, inside the window
    dt = time.perf_counter() - t0
    expect = sum(valid_per_feed[i % len(valid_per_feed)] for i in range(iters))
    return state, dt, total - base, expect
