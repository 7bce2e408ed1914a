"""The ``ra.*`` stage taxonomy: one source for the launch sites, the
capture window and the offline trace tools.

A copy of the reference's ``stages.py`` (``STAGES``, ``SCOPE_RE``,
``scope_of``), plus the port's two additions:

- :data:`KERNEL_STAGES`: for each hand-written CUDA kernel, the stages
  its one launch computes.  A hand kernel is the port's fusion boundary,
  as an XLA fusion is the reference's, so this is the counterpart of the
  reference capture's per-fusion stage sets.  The first stage of each is
  the one its launch runs under.
- :func:`scope`: the launch sites' stage range.  The reference's
  ``jax.named_scope`` costs nothing at run time (it rides HLO metadata);
  ``torch.profiler.record_function`` is not free even without a
  profiler, and the step issues 14-42 launches.  So ``scope`` is a
  shared no-op context unless a profiler of the port is live (a devprof
  capture window is open, or ``metrics.Profiler`` runs), and only then
  enters ``record_function(name)``.

The launch log (:func:`note_kernel`) is armed by a capture window only:
while it is, each hand kernel's wrapper appends ``(program, stage,
kernel)`` where it launches, so a trace whose kernel records carry no
correlated launch can still be attributed (runtime/devprof.py).

The stages the port's step emits:

   ra.unpack  wire bit-unpack + the weight plane (pipeline.batch_cols, batch_cols6)
   ra.match   v4 first-match kernel (first_match; match_hist, fused)
   ra.match6  v6 first-match kernel (first_match6)
   ra.counts  exact per-key counts (add64; the fused route's histogram fold)
   ra.cms     per-rule count-min adds (the key CMS)
   ra.hll     per-key HLL max (inside reg_tail_kernel)
   ra.talk    talker (acl, src) sketch update (reg_tail_kernel's launch)
   ra.topk    candidate table + top-k selection (select_kernel)
   ra.sort    register-key sorts of the reference's sorted update
              (ops/sorted_update.py): not ported, never emitted here
   ra.overlap static-analysis pair tiles (relation_grid_kernel)
   ra.merge   cross-shard and cross-process merges (parallel/step.py,
              parallel/distributed.py): only on a mesh of two or more
              shards; the one-device step has no merge
"""

from __future__ import annotations

import contextlib
import re
import threading

STAGES = (
    "ra.unpack",
    "ra.match",
    "ra.match6",
    "ra.counts",
    "ra.cms",
    "ra.hll",
    "ra.talk",
    "ra.topk",
    "ra.sort",
    "ra.merge",
    "ra.overlap",
)

#: Syntactic shape of a stage token inside a range name or a scope path.
#: Broader than :data:`STAGES` membership: classifiers accept any token,
#: and the offline tool flags tokens missing from STAGES.
SCOPE_RE = re.compile(r"ra\.[a-z0-9_]+")


def scope_of(op_name: str | None) -> str | None:
    """Outermost ``ra.*`` scope token of a scope path.

    Outermost wins so a wrapping stage owns its helpers: the talker
    plane's ``ra.talk/ra.cms/...`` classifies as ``ra.talk`` even though
    the inner scatter is the shared CMS kernel.
    """
    m = SCOPE_RE.search(op_name or "")
    return m.group(0) if m else None


#: hand kernel (its ``__global__`` name) -> the stages its one launch
#: computes; the first is the stage its launch runs under
KERNEL_STAGES = {
    "first_match_kernel": ("ra.match",),
    "match_hist_kernel": ("ra.match", "ra.counts"),
    "first_match6_kernel": ("ra.match6",),
    "reg_tail_kernel": ("ra.talk", "ra.hll", "ra.counts", "ra.topk"),
    "select_kernel": ("ra.topk",),
    "select_rank_kernel": ("ra.topk",),
    "relation_grid_kernel": ("ra.overlap",),
}

_NULL = contextlib.nullcontext()
#: profilers of the port now live (devprof windows, metrics.Profiler)
_live = 0
_live_lock = threading.Lock()
_tls = threading.local()
#: the armed launch log (a list), or None
_log: list | None = None
#: the program (dispatch label) now running inside a capture window
_program: str | None = None


def set_live(on: bool) -> None:
    """A profiler of the port starts (True) or stops (False)."""
    global _live
    with _live_lock:
        _live = max(0, _live + (1 if on else -1))


def live() -> bool:
    return _live > 0


class _Scope:
    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function

        self._rf = record_function(self.name)
        self._rf.__enter__()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()
        return self._rf.__exit__(*exc)


def scope(name: str):
    """The stage range ``name`` around a launch site: a shared no-op
    context while no profiler of the port is live, else
    ``torch.profiler.record_function(name)``."""
    if not _live:
        return _NULL
    return _Scope(name)


def current_stage() -> str | None:
    """Outermost ``ra.*`` range open on this thread (None outside any)."""
    for name in getattr(_tls, "stack", None) or ():
        s = scope_of(name)
        if s is not None:
            return s
    return None


def note_kernel(kernel: str) -> None:
    """A hand kernel's wrapper ran (on a CUDA tensor: launched ``kernel``;
    on the CPU: its plain version).  One None-check unless a capture
    window armed the log."""
    log = _log
    if log is not None:
        log.append((_program, current_stage(), kernel))
