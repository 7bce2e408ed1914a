"""Native fast path for the host parse: ctypes binding to the C++ parser.

The Python line parser (``syslog.parse_line``) runs at tens of thousands
of lines per second, far below what the card's step takes, so the
end-to-end rate of a text run is the parser's.  This module compiles the
port's own C++ parser/packer (``ruleset_analysis_tpu_torch/native/``) on
first use and exposes:

- :class:`NativePacker` — producer of the same column-major
  ``[TUPLE_COLS, B]`` uint32 batches as the Python ``LineBatcher``, but
  straight from raw bytes, across several native threads; for a ruleset
  with IPv6 rows it parses through the dual-family entry and stages the
  v6 rows for :meth:`NativePacker.take_v6`;
- :func:`batches_from_files` — stream syslog files as batches of
  ``batch_size`` raw lines each, with the Python path's batch
  boundaries.

The library is built with ``g++`` (or ``$CXX``) into ``build/native/`` at
the root of the checkout, named by a hash of the sources, flags and
machine, so an unchanged source is reused.  Concurrent first use (test
workers, several processes) is safe: builds take a file lock and each
library lands under its final name by ``os.replace``, so no process
loads a half-written file.  Without a compiler the import still works,
:func:`available` returns False, and :class:`NativePacker` raises
:class:`~..errors.NativeParserUnavailable`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from ..errors import NativeParserUnavailable, ResumeInputMismatch
from .pack import TUPLE6_COLS, TUPLE_COLS, PackedRuleset

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: translation units linked into the library (native/Makefile's OBJS)
UNITS = (
    "asaparse.cpp", "asaparse_avx2.cpp", "asaparse_neon.cpp",
    "simd_scan_avx2.cpp", "simd_scan_neon.cpp",
)
#: the units that take the AVX2 flag on x86-64
AVX2_UNITS = ("asaparse_avx2.cpp", "simd_scan_avx2.cpp")
#: native/Makefile's CXXFLAGS (a test holds the two equal)
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

#: Bytes per read when streaming a file through the native parser.
READ_BLOCK = 8 << 20

_lock = threading.Lock()


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _avx2_flags() -> tuple[str, ...]:
    return ("-mavx2",) if platform.machine() in ("x86_64", "AMD64") else ()


def library_path(cxx: str) -> Path:
    """Where the library for these sources, flags and machine lives."""
    h = hashlib.sha256(" ".join((cxx, *CXXFLAGS, *_avx2_flags(), platform.machine())).encode())
    for f in sorted(NATIVE_DIR.iterdir()):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"_asaparse-{h.hexdigest()[:16]}.so"


def _compile(cxx: str, out: Path) -> None:
    """Compile every unit in parallel into a temp dir, link, move into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for unit in UNITS:
            extra = _avx2_flags() if unit in AVX2_UNITS else ()
            cmd = [cxx, *CXXFLAGS, *extra, "-c", "-o", str(tmp / (unit + ".o")),
                   str(NATIVE_DIR / unit)]
            procs.append((unit, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for unit, proc in procs:
            log, _ = proc.communicate(timeout=300)
            if proc.returncode != 0:
                failed.append(f"{unit}: {log.decode(errors='replace')}")
        if failed:
            raise NativeParserUnavailable("native parser build failed:\n" + "\n".join(failed))
        lib = tmp / "_asaparse.so"
        r = subprocess.run(
            [cxx, *CXXFLAGS, "-shared", "-o", str(lib), *(str(tmp / (u + ".o")) for u in UNITS)],
            capture_output=True, text=True, timeout=300,
        )
        if r.returncode != 0:
            raise NativeParserUnavailable(f"native parser link failed:\n{r.stdout}{r.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build() -> Path:
    """The library's path, compiled first if needed (file-locked).

    Raises :class:`NativeParserUnavailable` when there is no compiler or
    the build fails.
    """
    cxx = _compiler()
    if cxx is None:
        raise NativeParserUnavailable(
            "native parser unavailable: no C++ compiler (g++ or $CXX) to build "
            "ruleset_analysis_tpu_torch/native/"
        )
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not out.exists():  # another process may have built it meanwhile
                try:
                    _compile(cxx, out)
                except (OSError, subprocess.TimeoutExpired) as e:
                    raise NativeParserUnavailable(f"native parser build failed: {e}") from e
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


#: a library built by another process, loaded as it is (see use_library)
_prebuilt: Path | None = None


def use_library(path: str | Path) -> None:
    """Load the library at ``path`` instead of building one.

    For spawned feed workers: the coordinator builds the library (under
    the build lock) before it starts them, and a worker must never run
    the compiler.  Call before the first load in the process.
    """
    global _prebuilt
    _prebuilt = Path(path)


@functools.cache
def _load_locked() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_prebuilt if _prebuilt is not None else build()))
    _bind(lib)
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library (built on first use); raises when unavailable."""
    with _lock:
        return _load_locked()


def _bind(lib: ctypes.CDLL) -> None:
    vp, i64, u32p, i64p = (ctypes.c_void_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64))
    lib.asa_packer_new.restype = vp
    lib.asa_packer_new.argtypes = []
    lib.asa_packer_free.argtypes = [vp]
    lib.asa_packer_free.restype = None
    for fn in (lib.asa_packer_add_acl, lib.asa_packer_add_binding, lib.asa_packer_add_binding_out):
        fn.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32]
        fn.restype = None
    lib.asa_packer_parsed.argtypes = [vp]
    lib.asa_packer_parsed.restype = i64
    lib.asa_packer_skipped.argtypes = [vp]
    lib.asa_packer_skipped.restype = i64
    lib.asa_packer_set_counts.argtypes = [vp, i64, i64]
    lib.asa_packer_set_counts.restype = None
    # buf params are c_void_p (not c_char_p) so both immutable bytes and
    # zero-copy views of a reusable bytearray can be passed
    lib.asa_pack_chunk_mt.argtypes = [vp, vp, i64, ctypes.c_int, i64, u32p, i64, i64p, i64p,
                                      ctypes.c_int]
    lib.asa_pack_chunk_mt.restype = i64
    # dual-family parse (v6-capable rulesets): v4 plane + TUPLE6 plane
    lib.asa_pack_chunk2.argtypes = [vp, vp, i64, ctypes.c_int, i64, u32p, i64, u32p, i64,
                                    i64p, i64p, i64p, ctypes.c_int]
    lib.asa_pack_chunk2.restype = i64
    lib.asa_count_lines.argtypes = [vp, i64, ctypes.c_int, i64, i64p]
    lib.asa_count_lines.restype = i64
    lib.asa_count_nl.argtypes = [vp, i64]
    lib.asa_count_nl.restype = i64
    lib.asa_coalesce.argtypes = [u32p, i64, i64, u32p, i64p]
    lib.asa_coalesce.restype = i64
    lib.asa_simd_kind.argtypes = []
    lib.asa_simd_kind.restype = ctypes.c_int
    lib.asa_simd_set.argtypes = [ctypes.c_int]
    lib.asa_simd_set.restype = None


def available() -> bool:
    """True if the native parser library loads (building it if needed)."""
    try:
        _load()
    except (NativeParserUnavailable, OSError):
        return False
    return True


def host_workers(env_var: str, cap: int) -> int:
    """Worker-count heuristic: ``env_var`` override, else usable cores."""
    env = os.environ.get(env_var)
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return max(1, min(n, cap))


def default_parse_threads() -> int:
    """Parse threads for the native path: RA_PARSE_THREADS or the usable cores (<= 32)."""
    return host_workers("RA_PARSE_THREADS", 32)


#: asa_simd_kind() codes -> ISA names.
_SIMD_KINDS = {0: "scalar", 1: "avx2", 2: "neon"}


def simd_kind() -> str:
    """Active tokenizer dispatch: ``"avx2"``/``"neon"``/``"scalar"``.

    ``"scalar"`` when the CPU has neither ISA or ``RA_SIMD=off`` (or
    :func:`set_simd`) disabled dispatch.  Raises when the library is
    unavailable.
    """
    return _SIMD_KINDS.get(int(_load().asa_simd_kind()), "scalar")


def set_simd(on: bool) -> str:
    """Force the tokenizer dispatch on/off in this process; returns :func:`simd_kind`.

    Outputs are byte-identical either way (tests compare the two);
    ``set_simd(True)`` on a CPU without AVX2/NEON stays ``"scalar"``.
    """
    _load().asa_simd_set(1 if on else 0)
    return simd_kind()


def native_coalesce(
    mat: np.ndarray, want_first: bool = False
) -> tuple[np.ndarray, np.ndarray | None] | None:
    """Native batch compaction, or None when the library is unavailable.

    ``mat`` is a ``[rows, B]`` uint32 plane whose LAST row is the
    weight/valid plane (see ``pack.coalesce_cols``, which owns the numpy
    version and the output contract — first-occurrence order, summed
    weights).  The hash pass releases the GIL (ctypes).
    """
    if not available():
        return None
    lib = _load()
    rows, b = mat.shape
    mat = np.ascontiguousarray(mat)
    scratch = np.empty((rows, b), dtype=np.uint32)
    first = np.empty(b, dtype=np.int64) if want_first else None
    u = int(lib.asa_coalesce(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), rows, b,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if first is not None else None,
    ))
    out = np.ascontiguousarray(scratch[:, :u])
    return out, (first[:u].copy() if first is not None else None)


def _as_buffer(data: bytes | bytearray | memoryview):
    """ctypes argument for a readable buffer, without copying.

    bytes pass through (immutable, ctypes pins them); bytearray/memoryview
    get a zero-copy ``from_buffer`` view — the caller must drop the
    returned object before resizing the underlying buffer.
    """
    if isinstance(data, bytes):
        return data
    return (ctypes.c_char * len(data)).from_buffer(data)


class NativePacker:
    """Raw syslog bytes -> column-major ``[TUPLE_COLS, B]`` uint32 batches.

    Mirrors the Python ``LinePacker``/``LineBatcher`` exactly: the
    (firewall, acl) -> gid and (firewall, iface) -> gid tables (in- and
    out-direction) come from the same PackedRuleset; unresolvable and
    unparseable lines count as skipped; valid tuples are packed densely
    from row 0.  A connection line whose ingress interface has an ``in``
    ACL and whose egress interface has an ``out`` ACL emits two rows;
    ``parsed`` counts evaluations, ``skipped`` counts lines that produced
    none.  For a ruleset with IPv6 rows the parse goes through the
    dual-family entry: v6 evaluations never take v4 batch capacity, they
    are staged for :meth:`take_v6`, as the Python text source stages
    them; against a pure-v4 ruleset an IPv6 line is a counted skip.
    """

    def __init__(self, packed: PackedRuleset):
        lib = _load()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.asa_packer_new())
        for (fw, acl), gid in packed.acl_gid.items():
            lib.asa_packer_add_acl(self._h, fw.encode(), acl.encode(), gid)
        for (fw, iface), gid in packed.bindings.items():
            lib.asa_packer_add_binding(self._h, fw.encode(), iface.encode(), gid)
        for (fw, iface), gid in packed.bindings_out.items():
            lib.asa_packer_add_binding_out(self._h, fw.encode(), iface.encode(), gid)
        #: with out-bindings a connection line can emit two rows
        self._rows_per_line = 2 if packed.bindings_out else 1
        self._has_v6 = packed.has_v6
        self._staged6: list[np.ndarray] = []

    def take_v6(self):
        """Drain staged v6 rows as ONE ``[n, TUPLE6_COLS]`` uint32 array.

        Empty list when nothing is staged.  The stream loop pulls this
        after every batch, as it does from the Python text source.
        """
        staged = self._staged6
        self._staged6 = []
        if not staged:
            return []
        if len(staged) == 1:
            return staged[0]
        return np.concatenate(staged)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.asa_packer_free(h)
            self._h = None

    @property
    def parsed(self) -> int:
        return int(self._lib.asa_packer_parsed(self._h))

    @property
    def skipped(self) -> int:
        return int(self._lib.asa_packer_skipped(self._h))

    def set_counts(self, parsed: int, skipped: int) -> None:
        """Restore cumulative counters."""
        self._lib.asa_packer_set_counts(self._h, parsed, skipped)

    def pack_chunk(
        self,
        data: bytes | bytearray | memoryview,
        batch_size: int,
        *,
        final: bool,
        max_lines: int | None = None,
        n_threads: int | None = None,
        length: int | None = None,
        out: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int, int]:
        """Parse up to ``max_lines`` (default batch_size) lines from data.

        Returns (batch [TUPLE_COLS, batch_size] uint32, lines_consumed,
        bytes_consumed).  With ``final=False`` a trailing fragment without
        a newline is left unconsumed — feed it back with the next block.
        A batch closes early, line-atomically, when the next line's rows
        would not fit.  ``n_threads`` (default :func:`default_parse_threads`)
        splits the parse across native workers; the output is
        bit-identical for any thread count.  ``length`` limits the parse
        to ``data[:length]``.  ``out`` is a preallocated C-contiguous
        ``[TUPLE_COLS, batch_size]`` uint32 destination (a shared-memory
        slot of the feeder) instead of a fresh array; every column of it
        is written, padding with valid = 0.
        """
        n = len(data) if length is None else length
        if not 0 <= n <= len(data):
            raise ValueError(f"length {n} outside the buffer of {len(data)} bytes")
        if out is None:
            out = np.empty((TUPLE_COLS, batch_size), dtype=np.uint32)
        elif (out.shape != (TUPLE_COLS, batch_size) or out.dtype != np.uint32
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous [TUPLE_COLS, {batch_size}] uint32 "
                             f"array, got {out.shape} {out.dtype}")
        n_lines = ctypes.c_int64(0)
        n_valid = ctypes.c_int64(0)
        ml = max_lines if max_lines is not None else batch_size
        threads = n_threads if n_threads is not None else default_parse_threads()
        u32p = ctypes.POINTER(ctypes.c_uint32)
        arg = _as_buffer(data)
        if self._has_v6:
            # the v6 plane holds 2 rows a line, so v6 rows never close a
            # batch (the Python text source's side buffer does the same)
            cap6 = 2 * ml
            out6 = np.empty((TUPLE6_COLS, cap6), dtype=np.uint32)
            n_valid6 = ctypes.c_int64(0)
            used = self._lib.asa_pack_chunk2(
                self._h, arg, n, 1 if final else 0, ml,
                out.ctypes.data_as(u32p), batch_size, out6.ctypes.data_as(u32p), cap6,
                ctypes.byref(n_lines), ctypes.byref(n_valid), ctypes.byref(n_valid6), threads,
            )
            del arg
            if n_valid6.value:
                self._staged6.append(np.ascontiguousarray(out6[:, : n_valid6.value].T))
            return out, int(n_lines.value), int(used)
        used = self._lib.asa_pack_chunk_mt(
            self._h, arg, n, 1 if final else 0, ml,
            out.ctypes.data_as(u32p), batch_size,
            ctypes.byref(n_lines), ctypes.byref(n_valid), threads,
        )
        del arg  # release the buffer export before the caller resizes
        return out, int(n_lines.value), int(used)

    def pack_lines(self, lines: list[str], batch_size: int | None = None) -> np.ndarray:
        """Row-major ``[B, TUPLE_COLS]`` batch of ``lines`` (tests, small inputs).

        v6 evaluations stay staged for :meth:`take_v6`; prefer
        :meth:`pack_lines2` when the lines may hold IPv6.
        """
        data = "".join(ln if ln.endswith("\n") else ln + "\n" for ln in lines).encode()
        b = batch_size if batch_size is not None else self._rows_per_line * len(lines)
        out, _, _ = self.pack_chunk(data, b, final=True, max_lines=len(lines))
        return np.ascontiguousarray(out.T)

    def pack_lines2(
        self, lines: list[str], batch_size: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """``LinePacker.pack_lines2`` twin: the padded row-major (v4, v6) pair."""
        b4 = self.pack_lines(lines, batch_size)
        rows6 = self.take_v6()
        out6 = np.zeros((b4.shape[0] if self._has_v6 else 0, TUPLE6_COLS), dtype=np.uint32)
        out6[: len(rows6)] = rows6
        return b4, out6


class _ChainedReader:
    """Several files as one byte stream, with line-boundary parity.

    A file whose last line is unterminated still contributes that line as
    a line of its own on the text path (``yield from f``); to keep the
    byte stream identical, a ``\\n`` is synthesized at any file boundary
    where the previous file did not end with one.
    """

    def __init__(self, paths: list[str]):
        self._paths = list(paths)
        self._i = 0
        self._f = None
        self._last = b"\n"

    def readinto(self, view: memoryview) -> int:
        """Fill ``view`` from the stream; 0 only at end of all files."""
        while True:
            if self._f is None:
                if self._i >= len(self._paths):
                    return 0
                self._f = open(self._paths[self._i], "rb")
                self._i += 1
            n = self._f.readinto(view)
            if n:
                self._last = bytes(view[n - 1 : n])
                return n
            self._f.close()
            self._f = None
            if self._last != b"\n":
                self._last = b"\n"
                view[0:1] = b"\n"
                return 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def batches_from_files(
    paths: list[str],
    packer: NativePacker,
    batch_size: int,
    *,
    skip_lines: int = 0,
    read_block: int = READ_BLOCK,
) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (batch [TUPLE_COLS, batch_size], raw_line_count) over files.

    The files are chained into one stream, so batch boundaries fall
    exactly where the Python text path puts them — per-chunk outputs
    (top-K candidates) match, not just the merged registers.
    ``skip_lines`` raw lines are skipped first without parsing; raises
    :class:`ResumeInputMismatch` if the input has fewer lines than that.
    """
    lib = packer._lib
    reader = _ChainedReader(paths)
    try:
        # One reusable bytearray filled with readinto: no per-block copies
        # and no join.  After each batch the unconsumed tail (at most
        # ~read_block bytes) moves to the front.
        buf = bytearray(2 * read_block)
        filled = 0  # bytes of buf holding live data
        nl = 0  # newlines within buf[:filled]
        eof = False

        def count_nl(start: int, end_: int) -> int:
            if end_ <= start:
                return 0
            arr = (ctypes.c_char * (end_ - start)).from_buffer(buf, start)
            try:
                return int(lib.asa_count_nl(arr, end_ - start))
            finally:
                del arr

        def fill() -> None:
            nonlocal filled, nl, eof
            if eof:
                return
            if len(buf) - filled < read_block:
                buf.extend(bytes(len(buf)))  # grow geometrically
            with memoryview(buf) as mv:
                n = reader.readinto(mv[filled : filled + read_block])
            if n == 0:
                eof = True
            else:
                nl += count_nl(filled, filled + n)
                filled += n

        def consume(used: int) -> None:
            """Drop buf[:used]; move the tail to the front."""
            nonlocal filled, nl
            if used == 0:
                return
            tail = filled - used
            buf[0:tail] = buf[used:filled]
            filled = tail
            nl = count_nl(0, filled)

        to_skip = skip_lines
        while to_skip > 0:
            if filled == 0 and not eof:
                fill()
            if filled == 0 and eof:
                raise ResumeInputMismatch(
                    f"asked to skip {skip_lines} lines but the input has "
                    f"only {skip_lines - to_skip}; wrong or truncated log input"
                )
            bytes_used = ctypes.c_int64(0)
            arg = _as_buffer(buf)
            skipped = lib.asa_count_lines(
                arg, filled, 1 if eof else 0, to_skip, ctypes.byref(bytes_used)
            )
            del arg
            to_skip -= int(skipped)
            consume(int(bytes_used.value))
            if to_skip > 0 and int(skipped) == 0:
                fill()  # newline-free fragment: grow the buffer to make progress
        # Buffer until batch_size COMPLETE lines are held, then close each
        # batch line-atomically: at most batch_size raw lines AND at most
        # batch_size tuple rows, so chunk boundaries land exactly where
        # the Python text path puts them.
        while True:
            while not eof and nl < batch_size:
                fill()
            if filled == 0 and eof:
                return
            batch, n_lines, used = packer.pack_chunk(buf, batch_size, final=eof, length=filled)
            consume(used)
            if n_lines == 0:
                if eof:
                    return
                # no complete line yet (a line longer than the buffered
                # bytes): read more so the loop always makes progress
                fill()
                continue
            yield batch, n_lines
    finally:
        reader.close()


def count_lines_in_file(path: str, read_block: int = READ_BLOCK) -> int:
    """Raw line count (a trailing unterminated fragment counts as a line)."""
    n = 0
    tail_fragment = False
    with open(path, "rb") as f:
        while True:
            block = f.read(read_block)
            if not block:
                break
            n += block.count(b"\n")
            tail_fragment = not block.endswith(b"\n")
    return n + (1 if tail_fragment else 0)
