"""Multi-process runs over ``torch.distributed``.

Counterpart of the reference's ``parallel/distributed.py``: one process
per device joins a job, feeds its own split of the input, and the SAME
sharded step (``parallel/step.py``) merges the registers across every
process with ``all_reduce`` and gathers the candidates with
``all_gather``.  The collectives move the small replicated registers,
never the batch.

The backend follows the device: NCCL when the ranks run on CUDA devices
(rank r of a host takes ``cuda:r``; two ranks never share a card, which
NCCL refuses), gloo when they run on the CPU.  The host-side
collectives here (has-data flags, counters, side tables) travel as
tensors on that backend's device.

The serve tier's epoch payload (``pack_epoch_payload``) comes with the
serve port.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..errors import DeviceUnavailable, DistributedLayoutError
from . import mesh as mesh_lib

#: Seconds a collective may wait on a peer before it fails: it bounds
#: dead-peer detection (the reference's heartbeat) and must outlast the
#: slowest rank's kernel build before the first step.
DEFAULT_TIMEOUT_SEC = 600


def _dist():
    import torch.distributed as dist

    return dist


def local_rank(process_id: int | None) -> int:
    """This process's index among the job's processes on its host:
    ``LOCAL_RANK`` when the launcher sets it, else ``process_id`` (every
    process on one host)."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    if process_id is not None:
        return int(process_id)
    return int(os.environ.get("RANK", "0"))


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, timeout: float | None = None, *,
                     device: str = "cuda") -> None:
    """Join (or start) a multi-process job.

    ``coordinator_address`` ``HOST:PORT`` rendezvous over TCP (process 0
    listens there); None reads the ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``device="cuda"`` takes
    the NCCL backend on ``cuda:<local rank>`` and refuses a rank past the
    host's card count (:class:`DistributedLayoutError`); ``"cpu"`` takes
    gloo.  ``timeout`` (seconds, default :data:`DEFAULT_TIMEOUT_SEC`)
    bounds every collective, so the survivors of a dead peer fail instead
    of hanging.
    """
    dist = _dist()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
                "to run a distributed job on the CPU over gloo"
            )
        local = local_rank(process_id)
        n_dev = torch.cuda.device_count()
        if not 0 <= local < n_dev:
            raise DistributedLayoutError(
                f"process {process_id} is local rank {local} on a host with {n_dev} CUDA "
                f"device(s): two ranks would share a card, which NCCL refuses; run at "
                f"most {n_dev} processes a host (or set LOCAL_RANK)"
            )
        torch.cuda.set_device(local)
        backend = "nccl"
        # the NCCL communicator forms now, not at the first collective of a
        # timed loop
        kw = {"device_id": torch.device("cuda", local)}
    elif device == "cpu":
        backend = "gloo"
        kw = {}
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        timeout=datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_SEC),
        **kw,
    )


def shutdown() -> None:
    """Leave the job (a no-op outside one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def collective_device() -> torch.device:
    """Where host-side collective tensors live: the rank's card under NCCL,
    else the CPU."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_global_mesh(*, topology: str = "flat", dcn: int = 0,
                     devices: list | None = None) -> mesh_lib.Mesh:
    """The mesh over every process's devices: this process's ``devices``
    (default: its one collective device) times the process count.

    ``topology="hybrid"``: an outer ``dcn`` axis (0 = one group per
    process) times an inner axis; devices order process-major, so each
    process's devices form one outer group, and reports equal the flat
    mesh's.
    """
    devs = list(devices) if devices is not None else [collective_device()]
    return mesh_lib.build_mesh(devs, topology, dcn, process_count(), process_index())


def all_processes_have_data(has_data: bool) -> bool:
    """True while ANY process still has input (one tiny all-reduce).

    The chunk loop is a collective program: every process must step the
    same number of times.  A process whose split ran dry keeps stepping
    all-invalid batches until every split is done; the register updates
    are weighted by the valid plane, so those rounds change nothing.
    """
    dist = _dist()
    t = torch.tensor([1 if has_data else 0], dtype=torch.int64, device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def value_across_processes(value: int) -> np.ndarray:
    """Every process's value, as a ``[process_count]`` int64 array."""
    dist = _dist()
    dev = collective_device()
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def allgather_rows(rows: np.ndarray) -> np.ndarray:
    """Concatenate a small per-process ``[n_i, C]`` uint32 array across
    processes, in process order (row counts first, then the rows padded
    to the largest count)."""
    dist = _dist()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    cols = rows.shape[1] if rows.ndim == 2 else 0
    counts = value_across_processes(rows.shape[0])
    m = int(counts.max()) if counts.size else 0
    if m == 0:
        return rows.reshape(0, cols)
    dev = collective_device()
    padded = torch.zeros((m, cols), dtype=torch.int64, device=dev)
    padded[: rows.shape[0]] = torch.from_numpy(rows.astype(np.int64)).to(dev)
    parts = [torch.empty_like(padded) for _ in range(process_count())]
    dist.all_gather(parts, padded)
    return np.concatenate(
        [parts[p][: int(counts[p])].cpu().numpy() for p in range(len(parts))]
    ).astype(np.uint32)


def sum_across_processes(values: dict[str, int]) -> dict[str, int]:
    """Per-process counters summed over every process (for ``totals``)."""
    dist = _dist()
    keys = sorted(values)
    t = torch.tensor([int(values[k]) for k in keys], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, t.cpu().tolist())}
