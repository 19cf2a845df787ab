"""Data-parallel process groups for VAE-GAM training, on torch.distributed.

Counterpart of ``vaegam_tpu.parallel.mesh``.  The JAX package runs one SPMD
program over a 1-D ('data',) mesh and lets XLA insert the collectives; here
R processes (ranks), one device each, run the same step on their own rows
of every global batch and meet in explicit collectives, so that a step over
R ranks computes the loss and the gradients of the single-process step on
the whole batch:

  * every rank walks the same seeded global batch order and holds the same
    parameters, optimizer state and generator state;
  * a rank receives the global batch's covariates and its own contiguous
    block of the global batch's volumes (:func:`batch_rows`);
  * what couples the rows of a batch is reduced across ranks: the norm
    statistics (:func:`all_reduce_sum`, differentiable), the global
    d-floor (:func:`all_reduce_max`), the loss terms, and the parameter
    gradients (:func:`all_reduce_grads`, one flat buffer per dtype); the
    gain sample spans the global batch and is computed on every rank;
  * host-side artifacts are written by rank 0 alone (:func:`is_main_process`).

Backends.  NCCL when every rank owns a card, gloo when ranks share a card or
run on the CPU (:func:`choose_backend`); the choice is made before the group
is joined and never changed because a backend failed.  gloo runs its
collectives on CUDA tensors by staging them through host memory.

``VAEGAM_COORDINATOR`` (host:port), ``VAEGAM_NUM_PROCESSES`` and
``VAEGAM_PROCESS_ID`` give :func:`init_multihost` its group, as they give the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data-parallel group: its rank, the world
    size, the backend, the rank's device and the torch.distributed group
    (None: the default group)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: object = None


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device=None) -> torch.device:
    """The device a rank runs on: ``device`` when given, else
    ``cuda:(rank mod visible cards)`` (also for a bare ``"cuda"``); raises
    without a card."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    resolve_device(None)  # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def _card_id(device: torch.device) -> str:
    """What names a card across processes: the host and the card's UUID;
    empty for a CPU rank."""
    if device.type != "cuda":
        return ""
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"


def choose_backend(cards: Sequence[str]) -> str:
    """NCCL when every rank owns a card of its own, else gloo.

    ``cards`` holds every rank's card id (empty for a CPU rank).  NCCL
    refuses two ranks on one card, so ranks that share a card, and CPU
    ranks, take gloo.
    """
    if all(cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device=None) -> DataMesh:
    """Join the data-parallel group and return this rank's mesh.

    Arguments default to ``VAEGAM_COORDINATOR`` / ``VAEGAM_NUM_PROCESSES`` /
    ``VAEGAM_PROCESS_ID``, as in the JAX package.  The coordinator's TCP
    store first collects every rank's card, which picks the backend
    (:func:`choose_backend`); then the group is joined and one eager
    collective creates the communicator (NCCL's must exist before a CUDA
    graph captures a collective).  A process already in a group of the
    same size and rank keeps it.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("VAEGAM_COORDINATOR")
    if num_processes is None and "VAEGAM_NUM_PROCESSES" in env:
        num_processes = int(env["VAEGAM_NUM_PROCESSES"])
    if process_id is None and "VAEGAM_PROCESS_ID" in env:
        process_id = int(env["VAEGAM_PROCESS_ID"])
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process group needs a coordinator, a process count and a "
            "process id (VAEGAM_COORDINATOR, VAEGAM_NUM_PROCESSES, "
            "VAEGAM_PROCESS_ID)")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()} already, not rank {process_id} of "
                f"{num_processes}")
        return make_data_mesh(device)
    device = rank_device(process_id, device)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=_TIMEOUT)
    store.set(f"card/{process_id}", _card_id(device))
    cards = [store.get(f"card/{r}").decode() for r in range(num_processes)]
    backend = choose_backend(cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=_TIMEOUT)
    mesh = DataMesh(process_id, num_processes, backend, device)
    dist.all_reduce(torch.zeros(1, device=device))
    return mesh


def make_data_mesh(device=None, group=None) -> DataMesh:
    """This rank's mesh over ``group`` (default: the default group).

    Without a group a one-process group is made first, on a free localhost
    port: NCCL on a card, gloo on the CPU, so that a world of one runs the
    same collectives as a larger one.
    """
    if not dist.is_initialized():
        return init_multihost(f"localhost:{free_port()}", 1, 0, device)
    rank = dist.get_rank(group)
    device = rank_device(dist.get_rank(), device)
    return DataMesh(rank, dist.get_world_size(group), dist.get_backend(group),
                    device, group)


def leave(mesh: Optional[DataMesh]) -> None:
    """Leave the default group, after a barrier (a no-op without one)."""
    if mesh is not None and dist.is_initialized():
        barrier(mesh)
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    """True when this process is one of several ranks."""
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main_process(mesh: Optional[DataMesh] = None) -> bool:
    """True on the process that writes host artifacts: rank 0 of ``mesh``
    (default: of the default group), or a lone process."""
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank (a no-op without a mesh)."""
    if mesh is not None:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# rows of a global batch
# ---------------------------------------------------------------------------

def batch_rows(n_rows: int, mesh: Optional[DataMesh],
               uneven: bool = False) -> Tuple[int, int]:
    """[lo, hi): this rank's contiguous block of a global batch of n_rows.

    Even batches split as JAX's P('data') places them: n_rows / R rows a
    rank in rank order.  A batch the world does not divide is refused
    unless ``uneven``, as ``jax.device_put`` and
    ``jax.make_array_from_callback`` refuse it; with ``uneven`` (the device
    cache's gather, which XLA splits without refusing) the first
    n_rows mod R ranks take one row more.  Every rank needs a row.
    """
    if mesh is None:
        return 0, n_rows
    world, rank = mesh.world, mesh.rank
    if n_rows % world and not uneven:
        raise ValueError(
            f"a global batch of {n_rows} rows does not divide evenly over "
            f"{world} ranks (JAX's P('data') placement refuses it too)")
    if n_rows < world:
        raise ValueError(f"a global batch of {n_rows} rows leaves a rank of "
                         f"{world} without a row")
    base, extra = divmod(n_rows, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def global_batch_from_rows(mesh: Optional[DataMesh], n_rows: int, fetch_rows):
    """This rank's block of a global batch from a row fetch function.

    ``fetch_rows(lo, hi)`` returns the host block of global rows [lo, hi);
    it is called once, for this rank's own rows, so each rank reads or
    decodes only its share of every batch (the JAX package's
    ``make_array_from_callback`` assembly).  Uneven batches are refused, as
    there.
    """
    lo, hi = batch_rows(n_rows, mesh)
    return fetch_rows(lo, hi)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _Counts:
    """Collective calls made by this process: ``calls`` by kind.  A call
    recorded into a CUDA graph counts once, at capture."""

    def __init__(self):
        self.calls = {}

    def add(self, kind: str) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def total(self) -> int:
        return sum(self.calls.values())


counts = _Counts()


def _all_reduce(t: torch.Tensor, mesh: DataMesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    counts.add("all_reduce")
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward sums the cotangents over ranks too,
    since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_reduce(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks."""
    return _AllReduceSum.apply(t, mesh)


class _MeanCotangent(torch.autograd.Function):
    """The identity, whose backward gives every rank the ranks' mean
    cotangent."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh) / ctx.mesh.world, None


def mean_cotangent(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` (replicated: every rank computes it over the global batch),
    differentiated with the ranks' mean cotangent in place of the rank's
    own share.  The summed gradients stay the same; a product upstream
    that rounds its cotangent (``ops.products``) then rounds the global
    cotangent, as one process does: exactly so for a power-of-two world,
    where the division by it is exact."""
    return _MeanCotangent.apply(t, mesh)


def all_reduce_max(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks (no gradient)."""
    return _all_reduce(t.detach().clone(), mesh, dist.ReduceOp.MAX)


def all_reduce_total(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Elementwise sum of ``t`` over the ranks (no gradient)."""
    return _all_reduce(t.detach().clone(), mesh)


class _GlobalValue(torch.autograd.Function):
    """The value of ``total`` with the gradient of ``local``."""

    @staticmethod
    def forward(ctx, local, total):
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_value(local: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """A rank's loss: the global total as its value, the rank's own share as
    what it differentiates (the shares' gradients sum to the total's)."""
    return _GlobalValue.apply(local, total.detach())


def _flat_by_dtype(tensors: Sequence[torch.Tensor], collective) -> List[torch.Tensor]:
    """Run ``collective`` in place on one flat buffer per dtype of
    ``tensors``; returns views of the buffers shaped as the tensors."""
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Sum gradients over the ranks: one flat buffer per dtype, one
    collective each."""
    return _flat_by_dtype(grads, lambda flat: _all_reduce(flat, mesh))


def all_gather_rows(t: torch.Tensor, mesh: DataMesh, n_rows: int) -> torch.Tensor:
    """The global batch of n_rows from every rank's block ``t`` of it
    (``batch_rows(n_rows, mesh, uneven=True)``); each rank receives all of
    it."""
    base = -(-n_rows // mesh.world)
    pad = torch.zeros((base,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    pad[:len(t)] = t
    parts = [torch.empty_like(pad) for _ in range(mesh.world)]
    counts.add("all_gather")
    dist.all_gather(parts, pad, group=mesh.group)
    blocks = []
    for r, part in enumerate(parts):
        lo, hi = batch_rows(n_rows, dataclasses.replace(mesh, rank=r), uneven=True)
        blocks.append(part[:hi - lo])
    return torch.cat(blocks)


@torch.no_grad()
def put_replicated(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> None:
    """Give every rank rank 0's values of ``tensors``, in place (one
    broadcast per dtype).  Every rank builds them from the same seed or the
    same checkpoint, so this only removes any doubt."""
    if mesh is None or mesh.world == 1:
        return

    def broadcast(flat):
        counts.add("broadcast")
        dist.broadcast(flat, 0, group=mesh.group)

    for t, value in zip(tensors, _flat_by_dtype(tensors, broadcast)):
        t.copy_(value)


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def replica_digests(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> List[str]:
    """Every rank's :func:`digest` of its ``tensors`` (equal when the ranks
    hold the same bytes)."""
    mine = digest(tensors)
    if mesh is None or mesh.world == 1:
        return [mine]
    out: List[Optional[str]] = [None] * mesh.world
    counts.add("all_gather_object")
    dist.all_gather_object(out, mine, group=mesh.group)
    return out
