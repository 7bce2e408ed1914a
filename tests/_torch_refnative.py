"""Load the reference's native parser before a port test uses it.

The reference builds ``ruleset_analysis_tpu/native/_asaparse.so`` with an
unlocked ``make`` on first use and remembers a failed load for the life
of the process.  Under parallel test workers on a fresh tree, a worker
that loads while another one relinks the library keeps that failure, and
its later native runs raise ``NativeParserUnavailable``.  This helper runs
the build itself (one worker at a time), clears the cached failure and
tries again, for up to a minute; it fails the test, never skips it.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, "build", ".refnative.lock")


def ensure_reference_native(timeout: float = 60.0):
    """The reference's ``hostside.fastparse`` module, its library loaded."""
    from ruleset_analysis_tpu.hostside import fastparse as rfast

    if rfast.available():
        return rfast
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    deadline = time.monotonic() + timeout
    log = ""
    while True:
        with open(LOCK, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                r = subprocess.run(["make", "-C", os.path.join(ROOT, "ruleset_analysis_tpu",
                                                               "native")],
                                   capture_output=True, text=True, timeout=120)
                log = r.stdout + r.stderr
                with rfast._lock:
                    rfast._tried = False
                    rfast._lib = None
                if rfast.available():
                    return rfast
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        if time.monotonic() > deadline:
            pytest.fail(f"the reference's native parser does not load:\n{log[-2000:]}")
        time.sleep(1.0)
