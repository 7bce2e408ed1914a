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


class WireCorrupt(AnalysisError):
    """A stored wire-format row failed its integrity invariant.

    The converter stores only valid evaluation rows, so a stored
    (non-padding) row with the valid bit clear means the block was
    damaged after conversion."""


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
#: a watchdog bounded a hang (stall)
EXIT_STALL = 6


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
    if isinstance(exc, (FeedWorkerError, IngestError, WireCorrupt, NativeParserUnavailable)):
        return EXIT_FEED
    return EXIT_ANALYSIS
