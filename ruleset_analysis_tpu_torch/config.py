"""Configuration of the port (the reference's ``config.py``, slimmed).

:class:`SketchConfig` is a verbatim copy — its defaults are part of the
answer, so they must not drift from the reference.  :class:`AnalysisConfig`
keeps only the knobs the port runs, plus its own ``match_impl`` and
``device``; ``checkpoint_dir`` defaults to ``$RA_OUTPUT_DIR/ckpt`` as in
the reference.  The weighted-input refusal table names the port's impls;
the port's ``fused`` plays the reference's ``pallas_fused`` in it and in
the pairing refusals of ``counts_impl``, ``update_impl`` and ``layout``
(the stacked layout needs ``scan``, where the reference needs ``xla``).
:class:`AutoscaleConfig` and :class:`ServeConfig` are the reference's,
fields, defaults and refusals.
"""

from __future__ import annotations

import dataclasses
import os

#: Directory for analysis outputs (checkpoints).
OUTPUT_DIR = os.environ.get("RA_OUTPUT_DIR", "out")

#: Maximum CMS depth — ops/hashing.py guarantees this many independent
#: multiply-shift constants.
MAX_CMS_DEPTH = 8


# ---------------------------------------------------------------------------
# Weighted-input compatibility: ONE declarative table.
#
# A weighted batch (coalesced on the fly, or a RAWIREv3 wire file whose
# rows carry original-line weights) is only correct through device
# formulations that are weight-linear (adds scale with the weight plane)
# or idempotent (max gates on weight > 0).  Two consumers read this
# table, so the refusal set cannot drift between them:
#
# - AnalysisConfig.__post_init__ — config-time refusal of ``coalesce``
#   with an incompatible impl choice;
# - runtime/stream.py::_check_weighted_input_config — run-time refusal
#   when a weighted WIRE input reaches a run whose config the validator
#   accepted (it never saw the input's weights).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WeightedRefusal:
    """One impl choice that cannot accept weighted (coalesced) inputs."""

    #: AnalysisConfig field and value naming the incompatible choice.
    field: str
    value: str
    #: Human reason, embedded in both refusal messages.
    reason: str
    #: Config-time `coalesce` refusal bound: None = refuse always; an int
    #: N = refuse only when batch_size >= N (below it the formulation's
    #: own guards keep the combination exact).  Weighted wire input is
    #: refused whatever the batch size: its weights are not bounded by it.
    coalesce_min_batch: int | None = None


WEIGHTED_INPUT_REFUSALS: tuple[WeightedRefusal, ...] = (
    WeightedRefusal(
        field="match_impl",
        value="fused",
        reason=(
            "the fused match_hist kernel's in-kernel count histogram is "
            "not weight-linear (it adds ONE per valid line, so a weight-w "
            "row would silently count as one line); use --match-impl scan"
        ),
    ),
    WeightedRefusal(
        field="counts_impl",
        value="matmul",
        reason=(
            "the matmul counts formulation is exact only while per-key "
            "per-chunk sums stay < 2^24 (f32 integer range), and a "
            "weighted chunk's summed weights are bounded by the "
            "ORIGINAL corpus lines behind it, not the stored batch "
            "size its shape guard sees; use 'scatter' or 'reduce'"
        ),
        coalesce_min_batch=1 << 24,
    ),
)

#: Per-chunk summed-weight ceiling for weighted wire inputs: the exact-
#: counts accumulator's carry detection (ops/counts.py add64) assumes
#: per-chunk deltas < 2^32.  A plain chunk satisfies it by shape; a
#: weighted chunk's delta is the original line count behind its rows, so
#: the stream driver refuses chunks at or past this bound
#: (runtime/stream.py::_WireFileSource._check_chunk_weight).
WEIGHTED_CHUNK_WEIGHT_LIMIT = 1 << 32


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
    #: Deferred candidate selection: select talker candidates only on
    #: chunks whose salt (chunk index) is a multiple of N; the talker CMS
    #: still absorbs every line.  1 = every chunk.
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
#: the reference's spellings of the match selector (its ``--match-impl
#: {xla,pallas}`` and ``--experimental-match-impl pallas_fused``) -> the
#: port's impl.  Its default, ``xla``, is the port's default ``scan``.
MATCH_IMPL_ALIASES = {"xla": "scan", "pallas": "scan", "pallas_fused": "fused"}
#: the reference's exact-counts and register-update formulations.  They
#: give the same registers by construction, so the port accepts each (with
#: the reference's refusals) and runs its one tail for all: the reg_tail
#: kernel (csrc/reg_tail.cu), whose per-line atomics are the scatter form.
COUNTS_IMPLS = ("scatter", "matmul", "reduce")
UPDATE_IMPLS = ("scatter", "sorted")
#: worker kinds of the multi-worker host feed (hostside/feeder.py)
FEED_MODES = ("process", "thread", "ring")
#: batch layouts: lines in source order, or bucketed by ACL (GroupBuffer)
LAYOUTS = ("flat", "stacked")
#: device mesh topologies (parallel/mesh.py)
MESH_SHAPES = ("flat", "hybrid")


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Everything the port's runtime needs to run one analysis job."""

    batch_size: int = 1 << 16  # log lines per device step
    sketch: SketchConfig = dataclasses.field(default_factory=SketchConfig)
    exact_counts: bool = True  # keep the exact per-rule bincount alongside sketches
    #: Ceiling on total device register memory (see pipeline.check_register_budget).
    register_memory_budget_bytes: int = 4 << 30
    #: "scan" (default; the reference's default "xla"): the first_match
    #: kernel, and the counts delta in the reg_tail kernel.  "fused" (the
    #: reference's opt-in "pallas_fused"): the match_hist kernel, which
    #: builds the counts itself and takes neither weighted input nor the
    #: stacked layout.
    match_impl: str = "scan"
    #: The reference's exact-counts formulation: one of COUNTS_IMPLS.  Only
    #: "scatter" pairs with match_impl="fused", whose kernel builds the
    #: counts itself.  Every one runs the same tail here.
    counts_impl: str = "scatter"
    #: The reference's register-update formulation: one of UPDATE_IMPLS;
    #: "sorted" needs match_impl="scan".  Every one runs the same tail here.
    update_impl: str = "scatter"
    #: Batch layout: "flat" steps lines in source order; "stacked" buckets
    #: them by ACL on the host (pack.GroupBuffer) and steps each grouped
    #: batch group-major on the scan route.  Registers are mergeable, so
    #: reports agree between layouts; the talker candidates follow the
    #: grouping, as in the reference.
    layout: str = "flat"
    #: Per-ACL lane width of a stacked grouped batch; 0 = auto
    #: (batch_size // n_acls).
    stacked_lane: int = 0
    #: "cuda" (default) or "cpu"; "cpu" runs every kernel's plain version.
    device: str = "cuda"
    #: Mesh topology: "flat" = one data axis over every device; "hybrid" =
    #: an outer "dcn" axis of ``mesh_dcn`` groups times an inner axis.
    #: Batches shard over both axes in the same device order and every
    #: register merge reduces over both, so reports equal the flat mesh's.
    mesh_shape: str = "flat"
    #: Outer (DCN) extent of the hybrid mesh; 0 = auto (the process count
    #: of a multi-process job, else 2).
    mesh_dcn: int = 0
    #: Pipelined ingest (runtime/ingest.py): a background producer parses,
    #: packs and starts the host-to-device copy of up to this many batches
    #: ahead of the device step.  0 = the synchronous loop.  Reports are
    #: identical at any depth.
    prefetch_depth: int = 2
    #: Watchdog on the prefetch producer: a producer that is alive but
    #: hands over no batch for this long raises StallError.
    stall_timeout_sec: float = 300.0
    #: Flow coalescing (runtime/coalesce.py): pre-aggregate each batch's
    #: duplicate evaluation tuples into (unique row, weight) pairs before
    #: the device step.  "auto" samples the first batches and turns itself
    #: off when the compaction ratio is too low to pay for the hash pass.
    coalesce: str = "off"
    #: Checkpoint/resume (runtime/checkpoint.py): an atomic (offset,
    #: registers) snapshot lands in ``checkpoint_dir`` every N chunks
    #: (0 = off) and once at the end of the run; with ``resume`` a run
    #: loads the snapshot there, skips its offset and goes on, ending
    #: bit-identical to a run that was never stopped.
    checkpoint_every_chunks: int = 0
    checkpoint_dir: str = os.path.join(OUTPUT_DIR, "ckpt")
    resume: bool = False
    #: Print a throughput line to stderr every N chunks (0 = never).
    report_every_chunks: int = 0
    #: Fault-injection schedule (runtime/faults.py; ``"site@N,site@N:k,
    #: seed=S"``).  Empty = every site disarmed.  The stream loop arms it
    #: at run start and exports it to RA_FAULT_PLAN, so spawned feed
    #: workers inherit it; a malformed spec raises AnalysisError there.
    fault_plan: str = ""
    #: Flight-recorder directory (runtime/flightrec.py).  Non-empty = the
    #: in-memory telemetry ring is armed for the run, and a typed abort,
    #: stall or crash dumps per-PID shards here, merged into
    #: ``postmortem.json``.  Empty = disarmed (the library default; the
    #: CLI defaults it to a ``blackbox`` dir beside the checkpoint dir).
    blackbox_dir: str = ""
    #: Retry-policy overrides (runtime/retrypolicy.py;
    #: ``"site=attempts[/base_sec],...,seed=S"`` or ``"off"``).  Empty =
    #: the built-in per-site defaults: retries are always armed.
    retry_policy: str = ""

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.checkpoint_every_chunks < 0:
            raise ValueError("checkpoint_every_chunks must be >= 0")
        if self.match_impl not in MATCH_IMPLS:
            raise ValueError(
                f"match_impl must be one of {MATCH_IMPLS}, got {self.match_impl!r}"
            )
        if self.counts_impl not in COUNTS_IMPLS:
            raise ValueError(
                "counts_impl must be 'scatter', 'matmul', or 'reduce', "
                f"got {self.counts_impl!r}"
            )
        if self.update_impl not in UPDATE_IMPLS:
            raise ValueError(
                f"update_impl must be 'scatter' or 'sorted', got {self.update_impl!r}"
            )
        if self.update_impl == "sorted" and self.match_impl == "fused":
            # the fused kernel builds the counts itself (its own scatter
            # tail), so the sorted counts would never run, and it is not
            # weight-linear, unsafe for the weighted inputs sorted serves
            raise ValueError(
                "update_impl='sorted' is incompatible with match_impl='fused' "
                "(the fused match_hist kernel builds counts in-kernel with its "
                "own scatter tail); use --match-impl scan"
            )
        if self.match_impl == "fused" and self.counts_impl != "scatter":
            raise ValueError(
                "match_impl='fused' computes counts in-kernel; "
                f"counts_impl={self.counts_impl!r} would be ignored — leave it "
                "'scatter' (the default), or use --match-impl scan"
            )
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be 'flat' or 'stacked', got {self.layout!r}")
        if self.mesh_shape not in MESH_SHAPES:
            raise ValueError(
                f"mesh_shape must be 'flat' or 'hybrid', got {self.mesh_shape!r}"
            )
        if self.mesh_dcn < 0:
            raise ValueError(f"mesh_dcn must be >= 0, got {self.mesh_dcn}")
        if self.mesh_dcn and self.mesh_shape != "hybrid":
            raise ValueError("mesh_dcn only applies to mesh_shape='hybrid'")
        if self.stacked_lane < 0:
            raise ValueError("stacked_lane must be >= 0")
        if self.layout == "stacked" and self.match_impl != "scan":
            # the reference's stacked step always scans (its XLA vmapped
            # match); the fused kernel's in-kernel histograms never run there
            raise ValueError(
                f"match_impl={self.match_impl!r} supports layout='flat' only; "
                "the stacked path always uses the first_match scan (--match-impl scan)"
            )
        if self.register_memory_budget_bytes < 1:
            raise ValueError("register_memory_budget_bytes must be >= 1")
        if not 0 <= self.prefetch_depth <= 1024:
            raise ValueError(
                f"prefetch_depth must be in 0..1024, got {self.prefetch_depth}"
            )
        if self.stall_timeout_sec <= 0:
            raise ValueError(
                f"stall_timeout_sec must be > 0, got {self.stall_timeout_sec}"
            )
        if self.coalesce not in ("off", "on", "auto"):
            raise ValueError(
                f"coalesce must be 'off', 'on', or 'auto', got {self.coalesce!r}"
            )
        if self.coalesce != "off":
            # coalesced batches reach the step weighted
            for r in WEIGHTED_INPUT_REFUSALS:
                if getattr(self, r.field) != r.value:
                    continue
                if r.coalesce_min_batch is None or self.batch_size >= r.coalesce_min_batch:
                    raise ValueError(
                        f"coalesce is incompatible with {r.field}={r.value!r}: {r.reason}"
                    )

    def to_dict(self) -> dict:
        """JSON-serializable image (the elastic supervisor hands it to its
        workers)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AnalysisConfig":
        """Inverse of :meth:`to_dict`; validation re-runs in __post_init__."""
        d = dict(d)
        d["sketch"] = SketchConfig(**d["sketch"])
        return AnalysisConfig(**d)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs of the metrics-driven elastic autoscaler
    (runtime/autoscale.py), the reference's fields, defaults and refusals.

    The policy reads two signals from the live metrics plane: **pressure**
    (the fraction of recent wall time the producer waited on a full queue:
    the device cannot keep up, scale OUT) and **starvation** (the fraction
    the consumer waited on an empty one: capacity is spare, scale IN), and
    decides only when a signal holds over a whole ``sustain_sec`` window.
    Flaps are damped three ways: the sustain window, a ``cooldown_sec``
    dead time after every decision, and the gap between the two
    thresholds.  ``reform_budget`` bounds the scale re-formations of one
    run as ``--max-reforms`` bounds the failure ones; 0 is observe-only
    (decisions are logged with their evidence and never acted on).
    """

    min_world: int = 1
    max_world: int = 0  # 0 = everything provisioned (the launcher pool)
    initial_world: int = 0  # 0 = the smallest allowed world
    out_threshold: float = 0.5  # sustained pressure >= this => scale out
    in_threshold: float = 0.8  # sustained starvation >= this => scale in
    sustain_sec: float = 3.0  # a signal must hold this long to count
    cooldown_sec: float = 10.0  # dead time after every decision
    reform_budget: int = 4  # scale re-formations allowed (0 = observe-only)
    poll_sec: float = 0.5  # metrics sampling cadence
    #: scripted decisions for drills and tests ("out@T,in@T": each entry
    #: fires T seconds after the engine starts observing, in order); empty =
    #: decide from the live signals
    plan: str = ""

    def __post_init__(self) -> None:
        if self.min_world < 1:
            raise ValueError(f"min_world must be >= 1, got {self.min_world}")
        if self.max_world < 0 or (self.max_world and self.max_world < self.min_world):
            raise ValueError(
                f"max_world must be 0 (= provisioned) or >= min_world, got "
                f"{self.max_world} (min_world {self.min_world})"
            )
        if self.initial_world < 0 or (
            self.initial_world
            and not self.min_world <= self.initial_world <= (self.max_world
                                                             or self.initial_world)
        ):
            raise ValueError(
                f"initial_world must be 0 or within "
                f"[{self.min_world}, {self.max_world or 'max'}], got {self.initial_world}"
            )
        for name in ("out_threshold", "in_threshold"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {v}")
        if self.sustain_sec <= 0 or self.poll_sec <= 0:
            raise ValueError("sustain_sec and poll_sec must be > 0")
        if self.cooldown_sec < 0:
            raise ValueError("cooldown_sec must be >= 0")
        if self.reform_budget < 0:
            raise ValueError("reform_budget must be >= 0")
        # the scripted plan is checked here, like every other knob, without
        # importing the engine
        for part in filter(None, (p.strip() for p in self.plan.split(","))):
            d, _, t = part.partition("@")
            if d not in ("out", "in"):
                raise ValueError(
                    f"autoscale plan entry {part!r}: direction must be 'out' or 'in'")
            try:
                if float(t) < 0:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"autoscale plan entry {part!r}: want DIRECTION@SECONDS") from None

    def to_dict(self) -> dict:
        """JSON-serializable image (the elastic supervisor hands it to its
        workers)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AutoscaleConfig":
        return AutoscaleConfig(**d)


@dataclasses.dataclass(frozen=True)
class DevprofConfig:
    """Device attribution capture window (runtime/devprof.py).

    ``run --devprof-out DIR`` arms one bounded ``torch.profiler`` window:
    dispatches ``1..warmup`` run unprofiled, the next ``steps`` dispatches
    are captured, and each device event is attributed to the outermost
    ``ra.*`` stage range around its launch; the result lands in
    ``DIR/devprof.json``, ``totals.devprof`` and the metrics JSONL.
    Single-controller capture only (the CLI refuses ``--distributed``).
    """

    out_dir: str
    steps: int = 16
    warmup: int = 3

    def __post_init__(self) -> None:
        if not self.out_dir:
            raise ValueError("devprof out_dir must be non-empty")
        if not 1 <= self.steps <= 4096:
            raise ValueError(
                f"devprof steps must be in 1..4096, got {self.steps}"
            )
        if not 0 <= self.warmup <= 4096:
            raise ValueError(
                f"devprof warmup must be in 0..4096, got {self.warmup}"
            )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration of the always-on ``serve`` mode (runtime/serve.py).

    Exactly one of ``window_lines`` / ``window_sec`` must be positive:
    line-count windows are deterministic and replayable (the same traffic
    always cuts at the same boundary), wall-clock windows are the
    production cadence ("unused in the last 24h" = merge the last
    ``86400/window_sec`` ring epochs).  ``epoch_store`` names the durable
    epoch store's directory (runtime/epochstore.py; empty: off) and
    ``epoch_store_budget_bytes`` its size, past which the oldest segments
    are evicted.
    """

    #: listener specs: ``udp:HOST:PORT``, ``tcp:HOST:PORT``, ``tail:PATH``,
    #: ``tail0:PATH``
    listen: tuple[str, ...] = ()
    window_lines: int = 0  # rotate after N received lines (deterministic)
    window_sec: float = 0.0  # rotate on a wall-clock cadence (production)
    ring: int = 8  # window epochs retained for merged views
    #: merged views (in windows) re-published at every rotation, e.g.
    #: (24, 168) for 24h/7d at a 1h window
    views: tuple[int, ...] = ()
    queue_lines: int = 1 << 16  # listener queue capacity (drops counted past it)
    http: str = "127.0.0.1:0"  # JSON endpoint bind; "off" disables
    serve_dir: str = os.path.join(OUTPUT_DIR, "serve")
    #: ring checkpoint cadence in windows (0 = never); the directory
    #: defaults to ``serve_dir/ckpt`` when empty
    checkpoint_every_windows: int = 1
    checkpoint_dir: str = ""
    reload_watch: bool = True  # poll the ruleset files; SIGHUP always works
    reload_poll_sec: float = 2.0
    max_windows: int = 0  # stop after N rotations (0 = run forever)
    stop_after_sec: float = 0.0  # soft wall deadline (0 = none)
    #: run the static ruleset analyzer at start and on every hot reload
    #: (unchanged ACLs reuse their verdicts): /report/static, and the
    #: evidence classes joined into every report
    static_analysis: bool = False
    #: per-rule witness-grid enumeration cap of the serve analyzer
    static_witness_budget: int = 4096
    #: durable ingest write-ahead log (runtime/wal.py): every consumed line
    #: appends before window accounting, so ``serve --resume`` after a hard
    #: kill replays the interrupted window over its delivered lines
    wal: bool = False
    wal_dir: str = ""  # empty = ``serve_dir/wal``
    wal_segment_bytes: int = 1 << 20
    #: total on-disk WAL budget; past it the OLDEST segment evicts, and its
    #: unreplayed records are exactly counted drops at the next resume
    wal_budget_bytes: int = 64 << 20
    #: window provenance: a sealed ``totals.lineage`` record per published
    #: window, appended to ``serve_dir/lineage.jsonl`` and served on /lineage
    lineage: bool = True
    #: SLO policy spec (runtime/metrics.py ``SloPolicy``); empty = no engine
    slo: str = ""
    #: per-rule trend hysteresis ratio (> 1), or 0 to disable
    trend_threshold: float = 4.0
    epoch_store: str = ""
    epoch_store_budget_bytes: int = 512 << 20

    def __post_init__(self) -> None:
        if (self.window_lines > 0) == (self.window_sec > 0):
            raise ValueError(
                "exactly one of window_lines/window_sec must be positive "
                f"(got lines={self.window_lines}, sec={self.window_sec})"
            )
        if self.window_lines < 0 or self.window_sec < 0:
            raise ValueError("window length must be positive")
        if self.ring < 1:
            raise ValueError(f"ring must be >= 1, got {self.ring}")
        if self.queue_lines < 1:
            raise ValueError(f"queue_lines must be >= 1, got {self.queue_lines}")
        if any(v < 1 for v in self.views):
            raise ValueError("views must be >= 1 window each")
        if any(v > self.ring for v in self.views):
            # a merged-24 view over an 8-epoch ring would claim 24
            # windows of evidence while holding 8: refuse, don't shrink
            raise ValueError(
                f"views {tuple(v for v in self.views if v > self.ring)} "
                f"exceed the ring ({self.ring} windows retained); raise "
                "--ring or lower --view"
            )
        if self.checkpoint_every_windows < 0:
            raise ValueError("checkpoint_every_windows must be >= 0")
        if self.reload_poll_sec <= 0:
            raise ValueError("reload_poll_sec must be > 0")
        if self.max_windows < 0 or self.stop_after_sec < 0:
            raise ValueError("max_windows/stop_after_sec must be >= 0")
        if self.static_witness_budget < 1:
            raise ValueError(
                f"static_witness_budget must be >= 1, got "
                f"{self.static_witness_budget}"
            )
        if self.wal_segment_bytes < 4096:
            raise ValueError(
                f"wal_segment_bytes must be >= 4096, got "
                f"{self.wal_segment_bytes}"
            )
        if self.wal_budget_bytes < 2 * self.wal_segment_bytes:
            # the budget must hold the rolling segment plus one sealed
            # predecessor, or every roll would evict at once
            raise ValueError(
                "wal_budget_bytes must be >= 2 * wal_segment_bytes "
                f"(got {self.wal_budget_bytes} vs segment "
                f"{self.wal_segment_bytes})"
            )
        if (self.wal_dir or self.wal_segment_bytes != 1 << 20
                or self.wal_budget_bytes != 64 << 20) and not self.wal:
            raise ValueError(
                "wal_dir/wal_segment_bytes/wal_budget_bytes require wal=True "
                "(serve --wal)"
            )
        if self.epoch_store_budget_bytes < 1 << 20:
            raise ValueError(
                "epoch_store_budget_bytes must be >= 1 MiB, got "
                f"{self.epoch_store_budget_bytes}"
            )
        if self.epoch_store_budget_bytes != 512 << 20 and not self.epoch_store:
            raise ValueError(
                "epoch_store_budget_bytes requires epoch_store "
                "(serve --epoch-store DIR)"
            )
        if self.trend_threshold != 0 and self.trend_threshold <= 1.0:
            raise ValueError(
                "trend_threshold must be > 1 (a multiplicative rate "
                f"band) or 0 to disable, got {self.trend_threshold}"
            )
        if self.slo:
            # a bad spec is a config-time ValueError, not a mid-serve one
            from .runtime.metrics import SloPolicy

            SloPolicy.parse(self.slo)
