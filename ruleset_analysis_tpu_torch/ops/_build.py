"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
The libraries go to ``build/kernels/`` at the root of the checkout (which
``.gitignore`` lists), named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  Nothing is
built at import: :func:`library` builds on first use, and
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..errors import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: kernel name -> source file in csrc/
SOURCES = {"first_match": "first_match.cu", "match_hist": "match_hist.cu",
           "first_match6": "first_match6.cu", "reg_tail": "reg_tail.cu",
           "relation_tile": "relation_tile.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_UP = ctypes.POINTER(ctypes.c_uint)
_PP = ctypes.POINTER(ctypes.c_void_p)
#: C signature of each library's functions (all return cudaError_t as int)
SIGNATURES = {
    "first_match": {
        "ra_first_match": [_P] * 7 + [_I, _P, _I, _P, _I, _P],
    },
    "match_hist": {
        "ra_match_hist": [_P] * 8 + [_I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P],
        "ra_match_hist_smem_limit": [_I, ctypes.POINTER(_I)],
    },
    "first_match6": {
        "ra_first_match6": [_P] * 13 + [_I, _P, _I, _P, _I, _P],
    },
    "reg_tail": {
        "ra_reg_tail": [_P, _P, _P, _PP, _I, _U, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I,
                        _P, _P, _I, _U, _I, _UP, _I, _P],
        "ra_reg_tail_smem_limit": [_I, ctypes.POINTER(_I)],
        "ra_select": [_P, _P, _I, _I, _P, _PP, _I, _U, _I, _U, _P, _I, _I, _UP, _I, _P, _P, _P,
                      _P, _P, _P],
        "ra_select_rank_cap": [],
    },
    "relation_tile": {
        "ra_relation_grid": [_P, _P, _I, _I, _P, _P, _P],
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _output(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns seconds spent per library built (empty when all were cached).
    Raises :class:`KernelError` with the compiler's output on failure.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _output(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _output(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    spent, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        spent[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return spent


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` resource usage) of a built library."""
    p = _output(name).with_suffix(".log")
    return p.read_text(errors="replace") if p.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build_all([name])
    lib = ctypes.CDLL(str(_output(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I
    lib.ra_error_string.argtypes = [_I]
    lib.ra_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error."""
    if rc != 0:
        msg = lib.ra_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what} failed: CUDA error {rc} ({msg})")
