"""Configuration of the port (the reference's ``config.py``, slimmed).

:class:`SketchConfig` is a verbatim copy — its defaults are part of the
answer, so they must not drift from the reference.  :class:`AnalysisConfig`
keeps only the knobs this slice runs, plus the port's own ``match_impl``
and ``device``.
"""

from __future__ import annotations

import dataclasses

#: Maximum CMS depth — ops/hashing.py guarantees this many independent
#: multiply-shift constants.
MAX_CMS_DEPTH = 8


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Geometry of the mergeable sketches kept on device.

    Defaults follow the usual error bounds: a count-min sketch of width ``w``
    and depth ``d`` over-estimates by at most ``e*N/w`` with probability
    ``1 - exp(-d)``; a HyperLogLog with ``m = 2**hll_p`` registers has
    relative error ``~1.04/sqrt(m)``.
    """

    cms_width: int = 1 << 14
    cms_depth: int = 4
    hll_p: int = 8  # 256 registers/rule -> ~6.5% per-rule cardinality error
    topk_capacity: int = 256  # host-side talker-summary size per ACL
    topk_chunk_candidates: int = 64  # device top-k candidates fed per chunk
    #: Depth of the (acl, src) talker CMS (its estimates only rank talkers).
    talk_cms_depth: int = 2
    #: Candidate-SELECTION subsampling: pick per-chunk talker candidates
    #: from every 2**shift-th line (the talker CMS still absorbs every
    #: line).  0 = select from the full batch.
    topk_sample_shift: int = 0
    #: Deferred candidate selection cadence (every Nth chunk).  Only 1 is
    #: ported; AnalysisConfig refuses other values.
    topk_every: int = 1

    def __post_init__(self) -> None:
        if self.cms_width < 2 or self.cms_width & (self.cms_width - 1):
            raise ValueError(f"cms_width must be a power of two >= 2, got {self.cms_width}")
        if not 1 <= self.cms_depth <= MAX_CMS_DEPTH:
            raise ValueError(f"cms_depth must be in 1..{MAX_CMS_DEPTH}, got {self.cms_depth}")
        if not 1 <= self.talk_cms_depth <= MAX_CMS_DEPTH:
            raise ValueError(
                f"talk_cms_depth must be in 1..{MAX_CMS_DEPTH}, got {self.talk_cms_depth}"
            )
        if not 1 <= self.hll_p <= 16:
            raise ValueError(f"hll_p must be in 1..16, got {self.hll_p}")
        if self.topk_capacity < 1 or self.topk_chunk_candidates < 1:
            raise ValueError("topk_capacity and topk_chunk_candidates must be >= 1")
        if not 0 <= self.topk_sample_shift <= 8:
            raise ValueError(
                f"topk_sample_shift must be in 0..8, got {self.topk_sample_shift}"
            )
        if not 1 <= self.topk_every <= 4096:
            raise ValueError(
                f"topk_every must be in 1..4096, got {self.topk_every}"
            )

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_p


#: match_impl -> the reference's equivalent selector value.  "fused" runs
#: csrc/match_hist.cu (scan + count histograms, the pallas_fused
#: counterpart); "scan" runs csrc/first_match.cu (the pallas counterpart)
#: and the scatter counts.
MATCH_IMPLS = ("fused", "scan")


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Everything the port's runtime needs to run one analysis job."""

    batch_size: int = 1 << 16  # log lines per device step
    sketch: SketchConfig = dataclasses.field(default_factory=SketchConfig)
    exact_counts: bool = True  # keep the exact per-rule bincount alongside sketches
    #: Ceiling on total device register memory (see pipeline.check_register_budget).
    register_memory_budget_bytes: int = 4 << 30
    match_impl: str = "fused"
    #: "cuda" (default) or "cpu"; "cpu" runs every kernel's plain version.
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.match_impl not in MATCH_IMPLS:
            raise ValueError(
                f"match_impl must be one of {MATCH_IMPLS}, got {self.match_impl!r}"
            )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.sketch.topk_every != 1:
            from .errors import NotPorted

            raise NotPorted("topk_every > 1 is not ported yet")
        if self.register_memory_budget_bytes < 1:
            raise ValueError("register_memory_budget_bytes must be >= 1")
