"""On-disk wire format: pre-tokenized syslog, 16 bytes/line, mmap-readable.

``convert`` parses text syslog ONCE (native C++ parser when available)
and writes a ``.rawire`` file holding each ACL evaluation as the same
4-word bit-packed row that crosses the host->device link
(``pack.compact_batch``: src | dst | sport<<16|dport |
proto<<24|valid<<23|acl).  A run over the file then skips the parse: the
mmap-backed reader feeds the device step at memory bandwidth.

The file is bound to the ruleset it was packed against: ACL gids are
ruleset-relative, so the header carries a ruleset fingerprint and the
reader refuses a mismatched ruleset instead of silently attributing hits
to the wrong ACLs.

The format is the reference package's, byte for byte, so either package
reads what the other wrote.  Layout (all little-endian):

  v1 header (plain rows), 64 bytes:
    0   magic      8s   b"RAWIREv1"
    8   block_rows u32  rows per payload block
    12  reserved   u32
    16  n_rows     u64  total evaluation rows in the payload
    24  raw_lines  u64  raw text lines the converter consumed
    32  n_evals    u64  evaluations emitted (== n_rows)
    40  n_skipped  u64  raw lines that produced no evaluation
    48  fp         16s  ruleset fingerprint (sha256 prefix)
  v2 header (an IPv6 section follows the v4 blocks), 72 bytes:
    0   magic      8s   b"RAWIREv2"
    8   block_rows u32
    12  reserved   u32
    16  n_rows     u64  v4 evaluation rows
    24  n6_rows    u64  rows of the IPv6 section
    32  raw_lines  u64
    40  n_evals    u64  evaluations (n_rows + n6_rows)
    48  n_skipped  u64
    56  fp         16s
  v3 header (coalesced, weighted rows), 72 bytes: the v2 layout with
    magic b"RAWIREv3", stored (unique) rows in n_rows and n6_rows, and
    the TRUE evaluation count (summed weights) in n_evals.
  payload: ceil(n_rows / block_rows) v4 blocks; block b holds
    r = min(block_rows, n_rows - b*block_rows) rows stored column-major
    as a C-contiguous [cols, r] uint32 plane (cols = WIRE_COLS, or
    WIREW_COLS with a trailing weights row in v3) — a whole block is a
    zero-copy mmap slice.  In v2 and v3 files the IPv6 section follows:
    ceil(n6_rows / block_rows) blocks of [WIRE6_COLS, r] rows (40 B/row;
    WIRE6W_COLS, 44 B/row, weighted).

A ruleset with IPv6 rows converts to v2 (v3 when coalesced), even when
the corpus holds no v6 line; a pure-v4 ruleset still writes v1.  Only
evaluation rows are stored; the header keeps the raw-line accounting so
reports state true input totals.  Rows appear in exactly the order the
text path evaluates them, family by family, so registers and per-rule
counts from a ``.rawire`` run are bit-identical to the text run.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
from collections.abc import Iterator

import numpy as np

from ..errors import AnalysisError, ResumeInputMismatch
from .pack import (
    T_VALID,
    TUPLE_COLS,
    W6_WEIGHT,
    W_META,
    W_WEIGHT,
    WIRE6_COLS,
    WIRE6W_COLS,
    WIRE_COLS,
    WIREW_COLS,
    PackedRuleset,
    coalesce_wire,
    coalesce_wire6,
    compact_batch,
    compact_batch6,
)

MAGIC = b"RAWIREv1"
#: an IPv6 section (40 B/row) follows the v4 blocks
MAGIC6 = b"RAWIREv2"
#: coalesced rows with a uint32 weights plane (20 B/row); ``n_evals``
#: keeps the TRUE evaluation count (summed weights)
MAGIC_W = b"RAWIREv3"
#: Placeholder magic while a convert is in flight; only a successful
#: ``WireWriter.close()`` replaces it, so a crashed or aborted convert
#: leaves a file every reader refuses instead of a silently short one.
MAGIC_PARTIAL = b"RAWIRE??"
HEADER_BYTES = 64
_HEADER_FMT = "<8sII4Q16s"
#: the 72-byte header of v2 and v3 files (v1 fields + the v6 row count)
HEADER6_BYTES = 72
_HEADER6_FMT = "<8sII5Q16s"
#: Default rows per payload block; equal to the default run batch size,
#: so the aligned read path hands mmap views straight to the device copy.
DEFAULT_BLOCK_ROWS = 1 << 16

ROW_BYTES = WIRE_COLS * 4  # 16 B/line
ROW6_BYTES = WIRE6_COLS * 4  # 40 B/line
ROWW_BYTES = WIREW_COLS * 4  # 20 B/row (weighted)
ROW6W_BYTES = WIRE6W_COLS * 4  # 44 B/row (weighted v6)


def ruleset_fingerprint(packed: PackedRuleset) -> bytes:
    """16-byte identity of the gid universe a wire file is valid for.

    Covers everything that maps a log line to (acl gid, key): the expanded
    rule matrices, deny keys, ACL gid assignment, and interface bindings.
    A pure-v4 ruleset hashes without a v6 term.
    """
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(packed.rules).tobytes())
    if packed.has_v6:
        h.update(np.ascontiguousarray(packed.rules6).tobytes())
    h.update(np.ascontiguousarray(packed.deny_key).tobytes())
    for (fw, acl), gid in sorted(packed.acl_gid.items()):
        h.update(f"a:{fw}/{acl}={gid};".encode())
    for (fw, iface), gid in sorted(packed.bindings.items()):
        h.update(f"i:{fw}/{iface}={gid};".encode())
    for (fw, iface), gid in sorted(packed.bindings_out.items()):
        h.update(f"o:{fw}/{iface}={gid};".encode())
    return h.digest()[:16]


class WireFormatError(AnalysisError):
    """Bad magic, truncated payload, or ruleset mismatch."""


class WireWriter:
    """Stream evaluation rows into a ``.rawire`` file.

    Feed dense wire-format column batches (``[WIRE_COLS, k]`` uint32, all
    rows valid; ``[WIREW_COLS, k]`` for a weighted writer) to
    :meth:`add`, and v6 rows to :meth:`add6` after :meth:`begin6`;
    blocks are written as they fill and the header is back-patched on
    close.  v6 rows spill to a sibling ``.spill6`` file while v4 blocks
    stream to the main file (the v6 section must follow every v4 block);
    a successful close appends the spill and deletes it, so memory stays
    one block per family.  Until :meth:`close` succeeds the header
    carries ``MAGIC_PARTIAL``, so a convert that crashes, is interrupted,
    or calls :meth:`abort` leaves a file every reader refuses.
    """

    def __init__(
        self,
        path: str,
        fp: bytes,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        weighted: bool = False,
    ):
        if block_rows <= 0:
            raise ValueError("block_rows must be positive")
        self._path = path
        self._f = open(path, "wb")
        self._fp = fp
        self.block_rows = block_rows
        #: v3 format: rows carry a weights plane; ``n_evals`` then tracks
        #: SUMMED weights (true evaluations), not stored rows
        self.weighted = weighted
        self._cols = WIREW_COLS if weighted else WIRE_COLS
        self._cols6 = WIRE6W_COLS if weighted else WIRE6_COLS
        self._evals = 0
        self.n_rows = 0
        self.n6_rows = 0
        self.raw_lines = 0
        self.n_skipped = 0
        self._buf = np.empty((self._cols, block_rows), dtype=np.uint32)
        self._fill = 0
        self._f6 = None
        self._buf6 = None
        self._fill6 = 0
        # v1 puts the payload at 64 bytes, v2/v3 at 72: the choice is made
        # before the first block lands (begin6), and v3 always takes 72
        self._payload_at = HEADER6_BYTES if weighted else HEADER_BYTES
        self._f.write(self._header(final=False))

    @property
    def n_evals(self) -> int:
        return self._evals if self.weighted else self.n_rows + self.n6_rows

    def begin6(self) -> None:
        """Declare that v6 rows may follow (call before the first add).

        Reserves the 72-byte v2 header.  A file that declared begin6 but
        saw no v6 row still closes as v2 with an empty v6 section.
        """
        if self._payload_at == HEADER6_BYTES:
            return  # weighted files (or repeated calls) already reserved it
        if self.n_rows or self._fill or self.n6_rows:
            raise RuntimeError("begin6() must precede the first add")
        self._payload_at = HEADER6_BYTES
        self._f.seek(0)
        self._f.truncate()
        self._f.write(self._header(final=False))

    def _header(self, final: bool = True) -> bytes:
        if self._payload_at == HEADER6_BYTES:
            magic = (MAGIC_W if self.weighted else MAGIC6) if final else MAGIC_PARTIAL
            return struct.pack(
                _HEADER6_FMT, magic, self.block_rows, 0, self.n_rows, self.n6_rows,
                self.raw_lines, self.n_evals, self.n_skipped, self._fp,
            )
        return struct.pack(
            _HEADER_FMT, MAGIC if final else MAGIC_PARTIAL, self.block_rows, 0,
            self.n_rows, self.raw_lines, self.n_rows, self.n_skipped, self._fp,
        )

    def add(self, wire: np.ndarray, raw_lines: int, skipped: int) -> None:
        """Append ``wire[:, :k]`` rows covering ``raw_lines`` text lines.

        Weighted writers take ``[WIREW_COLS, k]`` planes (weights row
        included) and fold the summed weights into ``n_evals``.
        """
        if wire.dtype != np.uint32 or wire.ndim != 2 or wire.shape[0] != self._cols:
            raise ValueError(f"expected [{self._cols}, k] uint32, got {wire.shape} {wire.dtype}")
        if self.weighted:
            self._evals += int(wire[W_WEIGHT].sum(dtype=np.uint64))
        self.raw_lines += raw_lines
        self.n_skipped += skipped
        pos = 0
        k = wire.shape[1]
        while pos < k:
            m = min(self.block_rows - self._fill, k - pos)
            self._buf[:, self._fill : self._fill + m] = wire[:, pos : pos + m]
            self._fill += m
            pos += m
            self.n_rows += m
            if self._fill == self.block_rows:
                self._f.write(self._buf.tobytes())
                self._fill = 0

    def add6(self, wire6: np.ndarray, raw_lines: int, skipped: int) -> None:
        """Append v6 rows (``[WIRE6_COLS, k]``; weighted: + weights row)."""
        if self._payload_at != HEADER6_BYTES:
            raise RuntimeError("call begin6() before the first add to write v6 rows")
        if wire6.dtype != np.uint32 or wire6.ndim != 2 or wire6.shape[0] != self._cols6:
            raise ValueError(
                f"expected [{self._cols6}, k] uint32, got {wire6.shape} {wire6.dtype}"
            )
        if self.weighted:
            self._evals += int(wire6[W6_WEIGHT].sum(dtype=np.uint64))
        if self._f6 is None:
            self._f6 = open(self._path + ".spill6", "wb")
            self._buf6 = np.empty((self._cols6, self.block_rows), dtype=np.uint32)
        self.raw_lines += raw_lines
        self.n_skipped += skipped
        pos = 0
        k = wire6.shape[1]
        while pos < k:
            m = min(self.block_rows - self._fill6, k - pos)
            self._buf6[:, self._fill6 : self._fill6 + m] = wire6[:, pos : pos + m]
            self._fill6 += m
            pos += m
            self.n6_rows += m
            if self._fill6 == self.block_rows:
                self._f6.write(self._buf6.tobytes())
                self._fill6 = 0

    def close(self) -> None:
        if self._f.closed:
            return
        if self._fill:
            self._f.write(np.ascontiguousarray(self._buf[:, : self._fill]).tobytes())
            self._fill = 0
        if self._f6 is not None:
            # append the v6 section after the last v4 block
            if self._fill6:
                self._f6.write(np.ascontiguousarray(self._buf6[:, : self._fill6]).tobytes())
                self._fill6 = 0
            self._f6.close()
            with open(self._path + ".spill6", "rb") as sf:
                while chunk := sf.read(1 << 22):
                    self._f.write(chunk)
            os.unlink(self._path + ".spill6")
            self._f6 = None
        self._f.flush()
        self._f.seek(0)
        self._f.write(self._header(final=True))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def abort(self) -> None:
        """Stop without finalizing: the partial-magic header stays, so the
        file is refused by every reader rather than read short."""
        if not self._f.closed:
            self._f.close()
        if self._f6 is not None:
            self._f6.close()
            try:
                os.unlink(self._path + ".spill6")
            except OSError:
                pass
            self._f6 = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


def is_wire_file(path: str) -> bool:
    """True if ``path`` is a wire file — complete or partial (cheap sniff).

    Routing decides between the text parser and :class:`WireReader`; a
    partial file fed to the text parser would silently skip every binary
    "line" and report a clean empty analysis, so it goes to the reader,
    which refuses it loudly.
    """
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) in (MAGIC, MAGIC6, MAGIC_W, MAGIC_PARTIAL)
    except OSError:
        return False


class _WireFile:
    """One mmap'd wire file, header-validated.

    Opening it (open, header read, mmap) is the wire path's IO seam, run
    under the ``wire.read`` retry policy (:func:`_open_wire_file`): a
    transient storage fault opens again, while the typed refusals (bad
    magic, truncation, another ruleset) are permanent.
    """

    def __init__(self, path: str, fp: bytes | None):
        from ..runtime import faults

        faults.fire("stream.wire.read.fail")
        self.path = path
        with open(path, "rb") as f:
            head = f.read(HEADER6_BYTES)
            if head.startswith(MAGIC_PARTIAL):
                raise WireFormatError(
                    f"{path!r} is an incomplete wire file (the convert that "
                    "wrote it crashed or was aborted); re-run the convert"
                )
            self.weighted = head.startswith(MAGIC_W)
            if head.startswith(MAGIC6) or self.weighted:
                if len(head) < HEADER6_BYTES:
                    raise WireFormatError(f"{path!r} is not a wire file (bad magic/header)")
                (_, self.block_rows, _r, self.n_rows, self.n6_rows, self.raw_lines,
                 self.n_evals, self.n_skipped, self.fp) = struct.unpack(_HEADER6_FMT, head)
                self._payload_at = HEADER6_BYTES
            elif head.startswith(MAGIC) and len(head) >= HEADER_BYTES:
                (_, self.block_rows, _r, self.n_rows, self.raw_lines,
                 self.n_evals, self.n_skipped, self.fp) = struct.unpack(
                    _HEADER_FMT, head[:HEADER_BYTES]
                )
                self.n6_rows = 0
                self._payload_at = HEADER_BYTES
            else:
                raise WireFormatError(f"{path!r} is not a wire file (bad magic/header)")
            if self.block_rows < 1:
                raise WireFormatError(f"{path!r} has a corrupt header (block_rows == 0)")
            if fp is not None and self.fp != fp:
                raise WireFormatError(
                    f"{path!r} was converted against a different ruleset "
                    "(fingerprint mismatch); re-run `convert` with the current "
                    "packed ruleset"
                )
            self.cols = WIREW_COLS if self.weighted else WIRE_COLS
            self.cols6 = WIRE6W_COLS if self.weighted else WIRE6_COLS
            self._row_bytes = ROWW_BYTES if self.weighted else ROW_BYTES
            self._row6_bytes = ROW6W_BYTES if self.weighted else ROW6_BYTES
            self._v6_at = self._payload_at + self.n_rows * self._row_bytes
            need = self._v6_at + self.n6_rows * self._row6_bytes
            size = os.fstat(f.fileno()).st_size
            if size < need:
                raise WireFormatError(
                    f"{path!r} is truncated: header claims {self.n_rows}+{self.n6_rows} "
                    f"rows ({need} bytes) but the file has {size}"
                )
            self._mm = (
                mmap.mmap(f.fileno(), need, access=mmap.ACCESS_READ)
                if self.n_rows or self.n6_rows else None
            )

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # a zero-copy block() view is still alive (e.g. held by an
                # in-flight exception's traceback); dropping our reference
                # lets GC unmap once the last view dies, and close() must
                # not replace the caller's real exception
                pass
            self._mm = None

    def _plane(self, at: int, cols: int, row_bytes: int, n: int, b: int) -> np.ndarray:
        start = b * self.block_rows
        r = min(self.block_rows, n - start)
        off = at + start * row_bytes
        arr = np.frombuffer(self._mm, dtype=np.uint32, count=cols * r, offset=off)
        return arr.reshape(cols, r)

    def block(self, b: int) -> np.ndarray:
        """Read-only ``[cols, r]`` view of v4 payload block ``b``."""
        return self._plane(self._payload_at, self.cols, self._row_bytes, self.n_rows, b)

    def block6(self, b: int) -> np.ndarray:
        """Read-only ``[cols6, r]`` view of v6-section block ``b``."""
        return self._plane(self._v6_at, self.cols6, self._row6_bytes, self.n6_rows, b)

    @property
    def n_blocks(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def n6_blocks(self) -> int:
        return -(-self.n6_rows // self.block_rows)


def _open_wire_file(path: str, fp: bytes | None) -> _WireFile:
    """One :class:`_WireFile` under the ``wire.read`` retry policy."""
    from ..runtime import retrypolicy

    return retrypolicy.call("wire.read", lambda: _WireFile(path, fp))


class WireReader:
    """mmap-backed batch source over one or more wire files.

    ``iter_batches`` (the v4 blocks) and ``iter_batches6`` (the IPv6
    sections, read after the v4 stream) re-chunk rows to exactly
    ``batch_size`` columns.  When a request lines up with a stored block
    (the default block_rows equals the default batch size), the yielded
    array is a zero-copy READ-ONLY mmap view: copy it before writing,
    never write through it.
    """

    def __init__(
        self,
        paths: list[str],
        packed: PackedRuleset | None = None,
        fingerprint: bytes | None = None,
    ):
        """``packed`` validates each file's ruleset fingerprint; callers
        inspecting many files can hash once and pass ``fingerprint``."""
        fp = fingerprint
        if fp is None and packed is not None:
            fp = ruleset_fingerprint(packed)
        self._files: list[_WireFile] = []
        try:
            for p in paths:
                self._files.append(_open_wire_file(p, fp))
        except BaseException:
            self.close()
            raise
        kinds = {f.weighted for f in self._files}
        if len(kinds) > 1:
            self.close()
            raise WireFormatError(
                "cannot mix weighted (RAWIREv3) and plain wire files in "
                "one input list; re-convert for a uniform set"
            )
        #: True when every file stores coalesced (weighted) rows
        self.weighted = bool(kinds.pop()) if kinds else False
        self._cols = WIREW_COLS if self.weighted else WIRE_COLS
        self._cols6 = WIRE6W_COLS if self.weighted else WIRE6_COLS
        blocks = {f.block_rows for f in self._files}
        #: common payload block size, or 0 when the files disagree
        self.block_rows = blocks.pop() if len(blocks) == 1 else 0
        self.n_rows = sum(f.n_rows for f in self._files)
        self.n6_rows = sum(f.n6_rows for f in self._files)
        self.raw_lines = sum(f.raw_lines for f in self._files)
        self.n_evals = sum(f.n_evals for f in self._files)
        self.n_skipped = sum(f.n_skipped for f in self._files)

    def close(self) -> None:
        for f in self._files:
            f.close()

    def iter_batches(self, skip_rows: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        """Yield ``([cols, batch_size] uint32, rows_in_batch)`` over the v4 blocks.

        The final partial batch is zero-padded to ``batch_size`` columns
        (zero meta == valid bit clear and weight 0, so padding is masked
        on device).  Raises ResumeInputMismatch if the files hold fewer
        than ``skip_rows`` rows.
        """
        return self._iter(skip_rows, batch_size, self.n_rows, self._cols,
                          lambda wf: (wf.n_rows, wf.n_blocks, wf.block))

    def iter_batches6(self, skip_rows: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        """Yield ``([cols6, batch_size] uint32, rows_in_batch)`` over the v6 sections.

        Every file's v6 section, concatenated; the stream loop reads it
        after the whole v4 stream.  Padding and zero-copy views as in
        :meth:`iter_batches`.
        """
        return self._iter(skip_rows, batch_size, self.n6_rows, self._cols6,
                          lambda wf: (wf.n6_rows, wf.n6_blocks, wf.block6))

    def _iter(self, skip_rows: int, batch_size: int, total: int, cols: int, section):
        if skip_rows > total:
            raise ResumeInputMismatch(
                f"asked to skip {skip_rows} rows but the wire input has "
                f"only {total}; wrong or truncated input"
            )
        return self._gen(skip_rows, batch_size, cols, section)

    def _gen(self, skip_rows: int, batch_size: int, cols: int, section):
        pend: np.ndarray | None = None  # partially filled output batch
        fill = 0
        to_skip = skip_rows
        for wf in self._files:
            n_rows, n_blocks, block = section(wf)
            if to_skip >= n_rows:
                to_skip -= n_rows
                continue
            b0 = to_skip // wf.block_rows
            to_skip -= b0 * wf.block_rows  # rows in the blocks jumped over
            for b in range(b0, n_blocks):
                blk = block(b)
                if to_skip:
                    drop = min(to_skip, blk.shape[1])
                    blk = blk[:, drop:]
                    to_skip -= drop
                    if not blk.shape[1]:
                        continue
                pos = 0
                n = blk.shape[1]
                if fill == 0 and n == batch_size:  # zero-copy: a full block
                    yield blk, n
                    continue
                while pos < n:
                    if pend is None:
                        pend = np.zeros((cols, batch_size), dtype=np.uint32)
                    m = min(batch_size - fill, n - pos)
                    pend[:, fill : fill + m] = blk[:, pos : pos + m]
                    fill += m
                    pos += m
                    if fill == batch_size:
                        yield pend, fill
                        pend = None
                        fill = 0
        if fill:
            yield pend, fill


def convert_logs(
    packed: PackedRuleset,
    log_paths: list[str],
    out_path: str,
    *,
    native: bool | None = None,
    batch_size: int = DEFAULT_BLOCK_ROWS,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    coalesce: bool = False,
    feed_workers: int = 0,
) -> dict:
    """Parse text syslog once and write a ``.rawire`` file; return stats.

    Uses the run path's batch sources (the native C++ parser when
    ``native`` is True, or None and the library builds; else the Python
    parser; with ``feed_workers > 1`` the multi-process feeder), so the
    row sequence written is exactly the one a text run feeds the device;
    the file is byte-identical either way, and to the reference's.  A
    ruleset with IPv6 rows writes v2 (v3 when coalesced): the v6 rows
    each batch staged go to the v6 section.

    ``coalesce=True`` writes the weighted v3 format: each per-batch run
    of duplicate evaluation tuples is stored ONCE with its repetition
    count.  Reports from a weighted run equal the plain file's.
    """
    from . import fastparse

    if feed_workers and feed_workers > 1:
        if native is False:
            raise ValueError("feed_workers requires the native parser; drop native=False")
        from .feeder import ParallelFeeder

        src = ParallelFeeder(packed, log_paths, n_workers=feed_workers)
        packer = src.packer
        batches = src.batches(0, batch_size)
        take_v6 = src.take_v6
        parser_name = f"native-feeder-x{feed_workers}"
    elif native if native is not None else fastparse.available():
        packer = fastparse.NativePacker(packed)
        batches = fastparse.batches_from_files(log_paths, packer, batch_size)
        take_v6 = packer.take_v6
        parser_name = "native"
    else:
        from ..runtime.stream import _iter_files, _TextSource

        src = _TextSource(packed, _iter_files(log_paths))
        packer = src.packer
        batches = src.batches(0, batch_size)
        take_v6 = src.take_v6
        parser_name = "python"

    last_skipped = 0
    with WireWriter(out_path, ruleset_fingerprint(packed), block_rows, weighted=coalesce) as w:
        if packed.has_v6:
            w.begin6()
        for batch, n_raw in batches:
            skipped = packer.skipped
            # keep only evaluation rows; a zero-row text batch (None)
            # still lands its raw-line and skip accounting in the header
            valid = (
                np.zeros((TUPLE_COLS, 0), dtype=np.uint32)
                if batch is None
                else batch[:, batch[T_VALID] == 1]
            )
            wire = compact_batch(valid)
            if coalesce:
                wire = coalesce_wire(wire)
            w.add(wire, n_raw, skipped - last_skipped)
            last_skipped = skipped
            rows6 = take_v6() if packed.has_v6 else []
            if len(rows6):
                wire6 = compact_batch6(np.asarray(rows6, dtype=np.uint32).T)
                if coalesce:
                    wire6 = coalesce_wire6(wire6)
                w.add6(wire6, 0, 0)
    return {
        "rows": w.n_rows,
        "rows6": w.n6_rows,
        "raw_lines": w.raw_lines,
        "evals": w.n_evals,
        "skipped": w.n_skipped,
        "bytes": os.path.getsize(out_path),
        "parser": parser_name,
        "weighted": coalesce,
    }


def sanity_check_valid_bits(wire: np.ndarray) -> tuple[int, int]:
    """(valid, invalid) row counts of a wire batch (meta bit 23)."""
    v = int(np.count_nonzero(wire[W_META] & np.uint32(1 << 23)))
    return v, wire.shape[1] - v
