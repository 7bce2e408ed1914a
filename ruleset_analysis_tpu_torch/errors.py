"""Error types of the port (the reference's ``errors.py`` subset it raises)."""


class AnalysisError(RuntimeError):
    """Base class for user-facing runtime errors."""


class NotPorted(AnalysisError):
    """The input needs a part of the reference not yet ported (IPv6 rows)."""


class DeviceUnavailable(AnalysisError):
    """A CUDA device was asked for (the default) but none is present."""


class KernelError(AnalysisError):
    """A hand-written kernel failed to build, load or launch."""
