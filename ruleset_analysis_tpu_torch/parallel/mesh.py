"""Device meshes and batch sharding.

Counterpart of the reference's ``parallel/mesh.py``.  Log lines are
independent records, so the batch axis shards across every device and
all register state stays replicated.  A :class:`Mesh` is an ordered list
of this process's devices with named axes and a shape over the devices
of every process:

- **flat**: one ``data`` axis over every device;
- **hybrid**: an outer ``dcn`` axis of host-sized groups times an inner
  ``data`` axis, the reference's two-level idiom.  Batches shard over
  both axes in the same device order and every merge reduces over both,
  so each report equals the flat mesh's over the same devices.

A device may appear more than once: ``[torch.device("cpu")] * n`` is a
mesh of n shards on the CPU (the counterpart of the reference tests'
``--xla_force_host_platform_device_count``), ``[cuda:0] * n`` one of n
virtual shards on one card.  Shards on one device share its register
replica; each distinct device holds one (``[cpu, cpu:0] * k`` keeps two
replicas on the CPU and merges between them as between two cards).  No
CLI flag builds such a mesh; the tests and ``chip_smoke.py`` do.

Every batch is split into contiguous per-shard column slices in mesh
order, and each slice is copied to its shard's device; on a CUDA device
through that device's :class:`~..runtime.ingest.H2DRing` (see
:func:`make_rings`).  One batch's copies are one ``device_put`` retry
unit (runtime/retrypolicy.py) behind one ``stream.device_put.fail``
fault site, as in the reference: a transient failure (an injected fault,
an allocation that ran out of device memory) copies the batch again with
seeded backoff, and any other error escalates at once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import AnalysisError, DeviceUnavailable
from ..hostside.pack import compact_batch, compact_batch_w, flatten_grouped
from ..runtime import faults, retrypolicy
from ..runtime.ingest import DeviceBatch, H2DRing, host_tensor, to_device

#: The batch axis (the inner one of the hybrid topology).
DATA_AXIS = "data"
#: Outer (between-host) axis of the hybrid topology.
DCN_AXIS = "dcn"


class Mesh:
    """This process's devices in mesh order, with axis names and the shape
    of the mesh over every process's devices (``n_processes`` processes,
    each holding as many devices as this one; this is ``process_index``)."""

    def __init__(self, devices, axis_names: tuple[str, ...], shape: dict[str, int],
                 n_processes: int = 1, process_index: int = 0):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape)
        self.n_processes = n_processes
        self.process_index = process_index
        #: distinct devices in first-use order: one register replica each
        self.local_devices = tuple(dict.fromkeys(self.devices))
        #: each shard's replica (index into local_devices)
        self.replica = tuple(self.local_devices.index(d) for d in self.devices)


def _normalize(dev) -> torch.device:
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device, in index order (the reference's
    ``jax.devices()``); no card is an error."""
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the kernels' plain versions on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_mesh(devices, topology: str, dcn: int, n_processes: int,
               process_index: int) -> Mesh:
    """The mesh of ``devices`` on each of ``n_processes`` processes, with the
    reference's hybrid refusals over the whole device count."""
    devs = [_normalize(d) for d in devices]
    if not devs:
        raise AnalysisError("a mesh needs at least one device")
    n = len(devs) * n_processes
    if topology == "flat":
        return Mesh(devs, (DATA_AXIS,), {DATA_AXIS: n}, n_processes, process_index)
    if topology != "hybrid":
        raise AnalysisError(f"unknown mesh topology {topology!r}")
    if dcn == 0:
        dcn = n_processes if n_processes > 1 else 2
    if dcn < 2:
        raise AnalysisError(f"hybrid mesh needs an outer (dcn) extent >= 2, got {dcn}")
    if n % dcn:
        raise AnalysisError(
            f"hybrid mesh: {n} devices do not divide into {dcn} dcn groups"
            " (pass --mesh-dcn that divides the device count)"
        )
    return Mesh(devs, (DCN_AXIS, DATA_AXIS), {DCN_AXIS: dcn, DATA_AXIS: n // dcn},
                n_processes, process_index)


def make_mesh(devices: list | None = None, *, topology: str = "flat", dcn: int = 0) -> Mesh:
    """The mesh of one process's devices (every visible CUDA device by default).

    ``topology="hybrid"`` arranges the devices as ``[dcn, n / dcn]`` (axes
    ``("dcn", "data")``), device order kept; ``dcn=0`` is the process count
    of a multi-process job, else 2.
    """
    devs = list(devices) if devices is not None else visible_devices()
    if dcn == 0 and _process_count() > 1:
        dcn = _process_count()
    return build_mesh(devs, topology, dcn, 1, 0)


def data_extent(mesh: Mesh) -> int:
    """Total batch-parallel width: every axis extent, every process's devices."""
    return int(math.prod(mesh.shape.values()))


def pad_batch_size(batch_size: int, mesh: Mesh) -> int:
    """Round ``batch_size`` up to a multiple of the total data width."""
    n = data_extent(mesh)
    return ((batch_size + n - 1) // n) * n


def make_rings(mesh: Mesh, slots: int) -> dict[torch.device, H2DRing] | None:
    """One pinned H2D ring per distinct CUDA device of ``mesh``, with
    ``slots`` buffers for each shard it holds; None when no device of
    ``mesh`` is a CUDA device."""
    rings = {d: H2DRing(d, slots * mesh.devices.count(d))
             for d in mesh.local_devices if d.type == "cuda"}
    return rings or None


def ring_totals(rings: dict[torch.device, H2DRing] | None) -> tuple[int, int]:
    """(bytes copied, pinned buffers allocated) over every ring."""
    if not rings:
        return 0, 0
    return sum(r.bytes for r in rings.values()), sum(r.allocs for r in rings.values())


def _width(mesh: Mesh, total: int) -> int:
    n = len(mesh.devices)
    if total % n:
        raise ValueError(
            f"a batch of {total} columns does not split over {n} devices; "
            "pad it with pad_batch_size"
        )
    return total // n


def _ring(rings, dev):
    return rings.get(dev) if rings else None


def shard_batch(mesh: Mesh, batch_np: np.ndarray,
                rings: dict | None = None) -> list[DeviceBatch]:
    """Host ``[C, B]`` -> one :class:`DeviceBatch` per shard: contiguous
    column slices in mesh order, each on its shard's device."""
    w = _width(mesh, batch_np.shape[-1])

    # the fault site fires before any pinned buffer is claimed, so a
    # failed attempt claims nothing; the host array is intact, so a
    # second attempt copies it again
    def _put():
        faults.fire("stream.device_put.fail")
        return [to_device(batch_np[:, i * w:(i + 1) * w], dev, _ring(rings, dev))
                for i, dev in enumerate(mesh.devices)]

    return retrypolicy.call("device_put", _put)


def shard_grouped(mesh: Mesh, grouped_np: np.ndarray, weighted: bool,
                  rings: dict | None = None) -> list[DeviceBatch]:
    """Host grouped ``[G, TUPLE_COLS, lane]`` -> one wire batch per shard.

    Shard d takes lanes ``[d * lane/n, (d+1) * lane/n)`` of every group and
    steps them group-major (the reference's per-device ``[G, C, lane/n]``
    shard read in its own group order), bit-packed as ``compact_batch_w``
    when rows may carry weights, else ``compact_batch``.
    """
    w = _width(mesh, grouped_np.shape[-1])
    pack = compact_batch_w if weighted else compact_batch

    def _put():
        faults.fire("stream.device_put.fail")
        return [to_device(pack(flatten_grouped(grouped_np[:, :, i * w:(i + 1) * w])), dev,
                          _ring(rings, dev))
                for i, dev in enumerate(mesh.devices)]

    return retrypolicy.call("device_put", _put)


def shard_ring_batch(mesh: Mesh, ring_batch,
                     rings: dict | None = None) -> list[DeviceBatch]:
    """A ring feeder batch -> one :class:`DeviceBatch` per shard.

    The feeder keeps one shared-memory ring per shard (``n_rings`` is the
    data extent), so view d is shard d's columns: each is bit-packed
    straight out of its slot and copied to its own device.  The slots are
    released once, when this returns or raises: the retry unit is inside
    (fire, pack, send), so a second attempt packs from slots that are
    still held.  The stream loop sends a one-device mesh's batches
    through :func:`~..runtime.ingest.views_to_device`, the same seam.
    """
    try:
        if len(ring_batch.views) != len(mesh.devices):
            raise ValueError(
                f"ring batch has {len(ring_batch.views)} views for {len(mesh.devices)} shards"
            )

        def _put():
            faults.fire("stream.device_put.fail")
            out = []
            for v, dev in zip(ring_batch.views, mesh.devices):
                ring = _ring(rings, dev)
                out.append(ring.put_views([v]) if ring is not None
                           else DeviceBatch(host_tensor(compact_batch(v)).to(dev)))
            return out

        return retrypolicy.call("device_put", _put)
    finally:
        ring_batch.release()
