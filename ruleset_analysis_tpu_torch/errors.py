"""Error types of the port (the reference's ``errors.py`` subset it raises)."""


class AnalysisError(RuntimeError):
    """Base class for user-facing runtime errors."""


class DeviceUnavailable(AnalysisError):
    """A CUDA device was asked for (the default) but none is present."""


class DistributedLayoutError(AnalysisError):
    """A multi-process job's layout cannot run: two ranks would share a card."""


class KernelError(AnalysisError):
    """A hand-written kernel failed to build, load or launch."""


class CheckpointMismatch(AnalysisError):
    """The snapshot belongs to another ruleset, sketch geometry, batch size
    or input kind (``checkpoint.fingerprint``)."""


class CheckpointCorrupt(AnalysisError):
    """The pointed-to snapshot exists but cannot be decoded.

    Raised instead of silently starting the analysis from scratch: a
    truncated or bit-flipped snapshot means storage trouble.  Recovery:
    delete the checkpoint directory (or repair storage) and rerun."""


class ResumeInputMismatch(AnalysisError):
    """The input is shorter than the number of lines or rows asked to skip."""


class NativeParserUnavailable(AnalysisError):
    """The C++ parser was requested but its library cannot be built or loaded."""


class FeedWorkerError(AnalysisError):
    """A parse feed worker (process or thread) died or reported failure.

    The multi-worker feed tiers raise this instead of waiting on a
    completion that will never arrive: a worker killed by the OS, a
    crashed parse, or ring slots the consumer never released."""


class IngestError(AnalysisError):
    """The prefetch producer failed with an untyped exception.

    The pipelined ingest re-raises producer-side failures at the
    consumer's next pull; failures that are not already AnalysisError
    subclasses are wrapped in this, so every failed run ends in a typed
    error (the original rides ``__cause__``).
    """


class StallError(AnalysisError):
    """The ingest watchdog fired: the producer is alive but made no
    progress within ``AnalysisConfig.stall_timeout_sec``."""


class WeightedInputRefused(AnalysisError):
    """A weighted (coalesced) input met a device formulation that is not
    weight-linear (``config.WEIGHTED_INPUT_REFUSALS``); a usage error."""


class ReformBudgetExhausted(AnalysisError):
    """The elastic supervisor used up ``--max-reforms`` re-formations."""


class AnalyzerContradiction(AnalysisError):
    """Live hit evidence contradicts a static "provably dead" verdict.

    A rule the analyzer certified as unreachable (shadowed, redundant or
    conflict) recorded hits under the same ruleset: the analyzer, the
    rule tensor or the counters are wrong, and a deletion report built
    from either would be untrustworthy (runtime/staticanalysis.py)."""


class WalQuarantine(AnalysisError):
    """The ingest write-ahead log refused an unusable directory or argument.

    Raised only when the WAL directory cannot be created or scanned (or a
    size or tenant key is out of range); a CRC-corrupt record inside a
    segment never raises: the segment is quarantined (renamed aside), the
    lost records are counted exactly where the seq arithmetic allows, and
    replay continues with the next segment (runtime/wal.py).  Exit code 1,
    as in the reference."""


class InjectedFault(AnalysisError):
    """A deterministic fault fired by an armed plan (runtime/faults.py).

    Typed as AnalysisError so that a faulted run ends in a typed abort,
    never a raw exception."""


class WireCorrupt(AnalysisError):
    """A stored wire-format row failed its integrity invariant.

    The converter stores only valid evaluation rows, so a stored
    (non-padding) row with the valid bit clear means the block was
    damaged after conversion."""


# ---------------------------------------------------------------------------
# Transient-vs-permanent classification, consulted by the retry engine
# (runtime/retrypolicy.py) at every wrapped seam.  A TRANSIENT failure may
# clear on a bounded retry with backoff (a flaky transfer, EINTR, a socket
# in TIME_WAIT, an allocation that ran out of device memory); a PERMANENT
# one never clears by waiting (a typed refusal, a missing file, a poisoned
# CUDA context, a programming error) and escalates at once.
# ---------------------------------------------------------------------------

import errno as _errno
import sys as _sys

#: OSError errnos that describe environmental, possibly-clearing faults.
TRANSIENT_ERRNOS = frozenset(
    getattr(_errno, name)
    for name in (
        "EAGAIN", "EINTR", "EIO", "EBUSY", "ENOBUFS", "ENOMEM",
        "EADDRINUSE", "ECONNRESET", "ECONNREFUSED", "ECONNABORTED",
        "ENETDOWN", "ENETUNREACH", "ENETRESET", "EHOSTUNREACH",
        "ETIMEDOUT", "EPIPE", "ESTALE", "EDQUOT", "ENOSPC",
    )
    if hasattr(_errno, name)
)


def _is_cuda_oom(exc: BaseException) -> bool:
    """``torch.cuda.OutOfMemoryError``, looked up without importing torch
    (feed workers import this module and must stay free of it)."""
    torch = _sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` describes a fault a bounded retry may clear.

    The reference's table, case for case, except where it reads XLA
    status tokens: there the port classifies torch's own errors.  An
    allocation that ran out of device memory (``torch.cuda.OutOfMemoryError``,
    the counterpart of ``RESOURCE_EXHAUSTED``) is transient.  Every other
    ``RuntimeError`` is permanent: a CUDA launch or memory error (an
    illegal address) poisons the context, and a retry on a dead context
    can only hide the fault.  InjectedFault, the chaos stand-in for
    environmental faults, is transient by definition; every other typed
    AnalysisError is a deliberate refusal.  Anything unrecognized is
    permanent.
    """
    if isinstance(exc, InjectedFault):
        return True
    if isinstance(exc, AnalysisError):
        return False  # typed refusals (corrupt ckpt, mismatch...) never retry
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    if isinstance(exc, (ConnectionError, InterruptedError, BlockingIOError,
                        TimeoutError)):
        return True  # includes socket.timeout and ECONNRESET et al.
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return _is_cuda_oom(exc)


# ---------------------------------------------------------------------------
# CLI exit codes: the reference's failure classes (its errors.py and README
# "Exit codes"), for the classes the port raises.  Supervisors and
# operators branch on them.
# ---------------------------------------------------------------------------

EXIT_OK = 0
#: generic analysis error (parse failure, missing input, uncategorized)
EXIT_ANALYSIS = 1
#: bad usage / invalid configuration (argparse-level and ValueError)
EXIT_USAGE = 2
#: a checkpoint exists but cannot be trusted (torn write, bit rot, CRC)
EXIT_CHECKPOINT_CORRUPT = 3
#: checkpoint/resume identity mismatch (foreign ruleset/geometry/input)
EXIT_CHECKPOINT_MISMATCH = 4
#: the feed tier failed (dead worker, corrupt wire block, producer bug)
EXIT_FEED = 5
#: a watchdog bounded a hang (stall, formation timeout)
EXIT_STALL = 6
#: elastic re-formation budget exhausted (--max-reforms)
EXIT_REFORM_BUDGET = 7

#: Human names of the reference's documented codes, 8 included (a fenced
#: distributed-serve supervisor): ``doctor`` reads bundles written by
#: either package.
EXIT_CODE_NAMES = {
    EXIT_OK: "ok",
    EXIT_ANALYSIS: "analysis-error",
    EXIT_USAGE: "usage",
    EXIT_CHECKPOINT_CORRUPT: "checkpoint-corrupt",
    EXIT_CHECKPOINT_MISMATCH: "checkpoint-mismatch",
    EXIT_FEED: "feed-failure",
    EXIT_STALL: "stall",
    EXIT_REFORM_BUDGET: "reform-budget-exhausted",
    8: "supervisor-fenced",
}


def exit_code_for(exc: BaseException) -> int:
    """The documented CLI exit code of a typed runtime error.

    Most specific first; anything else (plain AnalysisError included) is
    the catch-all 1.  A weighted input refused by the impl choice is a
    usage error, 2.
    """
    if isinstance(exc, WeightedInputRefused):
        return EXIT_USAGE
    if isinstance(exc, CheckpointCorrupt):
        return EXIT_CHECKPOINT_CORRUPT
    if isinstance(exc, (CheckpointMismatch, ResumeInputMismatch)):
        return EXIT_CHECKPOINT_MISMATCH
    if isinstance(exc, StallError):
        return EXIT_STALL
    if isinstance(exc, ReformBudgetExhausted):
        return EXIT_REFORM_BUDGET
    if isinstance(exc, (FeedWorkerError, IngestError, WireCorrupt, NativeParserUnavailable)):
        return EXIT_FEED
    return EXIT_ANALYSIS
