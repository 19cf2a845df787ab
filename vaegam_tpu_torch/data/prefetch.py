"""Pipelined host->device loader for datasets beyond the device cache.

Counterpart of ``vaegam_tpu.data.prefetch``: a worker thread decodes
future batches (``FMRIDataset.gather``) into pinned host buffers and copies
them to the card on a side CUDA stream while the card computes on the
current one.  At most ``depth`` batches are in flight.

  * Each batch's copy records a CUDA event on the copy stream; the batch is
    handed out after the consuming stream is told to wait on that event,
    so the step reads it only once it has landed, without a host sync.
  * A pinned buffer set is handed to a worker again only after the event of
    its previous copy has completed (the host waits on that event alone).
  * ``transfer_dtype`` "float16" / "bfloat16" casts the volumes on the host
    (round to nearest even: numpy's float16, torch's bfloat16, which equals
    ``ml_dtypes``' bytes) and restores float32 on the device, on the copy
    stream: half the bytes over the link.  Covariates travel in float32.

Batches, order and values are the JAX loader's: the shuffle after
``set_epoch(k)`` is ``np.random.default_rng((seed, k))``, the rows are
``FMRIDataset.gather``'s, and the wire rounds as JAX's does.  Each batch is
``{volume, covariates}`` as float32 device tensors and ``{subjid, vol_num}``
as host numpy.  On the CPU (``device="cpu"``) the same batches come
without streams or pinned memory.  Like the JAX loader it has no
``iter_index_batches``: the Trainer feeds its steps one batch at a time.

Data parallel (``mesh``): every rank walks the same global batch order and
decodes and copies ONLY its own block of each global batch's volumes
(``parallel.global_batch_from_rows``, as the JAX loader assembles a global
array from per-shard callbacks); the batch's covariates, subject indices
and volume numbers are the global batch's, read without a decode.  A batch
the ranks do not divide is refused, as the JAX loader refuses it, and so
is row sharding (``shard_index``/``num_shards``) under a multi-process
mesh.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import global_batch_from_rows
from .dataset import FMRIDataset, check_row_sharding

_WIRE = {"float32": None, "float16": torch.float16, "bfloat16": torch.bfloat16}


class _PinnedSets:
    """``count`` pinned (volume, covariate) buffer pairs in rotation; a set
    is handed out again only after the copy that last read it has
    completed."""

    def __init__(self, count: int, batch: int, vol_shape, n_cov: int, wire):
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(count):
            self._free.put((torch.empty(vol_shape, dtype=wire, pin_memory=True),
                            torch.empty((batch, n_cov), pin_memory=True), None))

    def claim(self):
        vols, covs, event = self._free.get()
        if event is not None:
            event.synchronize()
        return vols, covs

    def release(self, vols, covs, event) -> None:
        self._free.put((vols, covs, event))


class PrefetchLoader:
    """JAX's arguments and defaults (``depth=3``, ``workers=1``,
    ``transfer_dtype``, ``drop_last``, ``mesh``, ``shard_index``/
    ``num_shards``), plus ``device`` (the card unless given; the mesh's
    device under a mesh)."""

    def __init__(
        self,
        dataset: FMRIDataset,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        mesh=None,
        depth: int = 3,
        workers: int = 1,
        shard_index: int = 0,
        num_shards: int = 1,
        transfer_dtype: str = "float32",
        device=None,
    ):
        check_row_sharding(mesh, num_shards)
        if depth < 1:
            raise ValueError(f"depth {depth}: at least 1")
        if transfer_dtype not in _WIRE:
            raise ValueError(f"transfer_dtype {transfer_dtype!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.depth = depth
        self.workers = workers
        self.transfer_dtype = transfer_dtype
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self._rows = np.arange(len(dataset))[shard_index::num_shards]
        self._wire = _WIRE[transfer_dtype]
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._epoch = None
        self._pinned = None
        self._copy_stream = None

    def __len__(self) -> int:
        n = len(self._rows)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        """Sample count: the per-epoch loss denominator (the reference's
        len(dataset), vae_reg_GP.py:430)."""
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        """Make the next shuffle a pure function of (seed, epoch)."""
        self._epoch = int(epoch)

    def _epoch_rng(self):
        if self._epoch is not None:
            return np.random.default_rng((self._seed, self._epoch))
        return self._rng

    def _host_wire(self, vols: np.ndarray) -> torch.Tensor:
        """The volumes as they cross the link: float32, or cast on the host."""
        if self._wire is None:
            return torch.from_numpy(vols)
        if self._wire == torch.float16:
            return torch.from_numpy(vols.astype(np.float16))
        return torch.from_numpy(vols).to(torch.bfloat16)

    def _make_batch(self, sel: np.ndarray) -> Dict[str, object]:
        """Decode rows `sel` (this rank's block of them under a mesh); on the
        card, copy them over on the copy stream and record the copy's event
        (the consumer waits on it)."""
        host = self.dataset.meta(sel)
        vols = global_batch_from_rows(
            self.mesh, len(sel),
            lambda lo, hi: self.dataset.gather(sel[lo:hi])["volume"])
        vols = self._host_wire(vols)
        covs = torch.from_numpy(host["covariates"])
        event = None
        if self.device.type == "cuda":
            pin_vols, pin_covs = self._pinned.claim()
            n, m = len(vols), len(sel)
            pin_vols[:n].copy_(vols)
            pin_covs[:m].copy_(covs)
            with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
                vols = pin_vols[:n].to(self.device, non_blocking=True)
                covs = pin_covs[:m].to(self.device, non_blocking=True)
                vols = vols.float()
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            self._pinned.release(pin_vols, pin_covs, event)
        else:
            vols = vols.float()
        return {"volume": vols, "covariates": covs, "subjid": host["subjid"],
                "vol_num": host["vol_num"], "_event": event}

    def _hand_out(self, batch) -> Dict[str, object]:
        """Make the consuming stream wait for the batch's copy."""
        event = batch.pop("_event")
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            batch["volume"].record_stream(stream)
            batch["covariates"].record_stream(stream)
        return batch

    def __iter__(self) -> Iterator[Dict[str, object]]:
        order = self._rows.copy()
        if self.shuffle:
            self._epoch_rng().shuffle(order)
        batches = [order[start:start + self.batch_size]
                   for start in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.device.type == "cuda" and self._pinned is None:
            rows = -(-self.batch_size // (1 if self.mesh is None else self.mesh.world))
            shape = (rows,) + self.dataset[0]["volume"].shape
            self._pinned = _PinnedSets(self.depth + 1, self.batch_size, shape,
                                       self.dataset[0]["covariates"].shape[0],
                                       self._wire or torch.float32)
            self._copy_stream = torch.cuda.Stream(self.device)
        pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            in_flight = [pool.submit(self._make_batch, sel) for sel in batches[:self.depth]]
            next_submit = self.depth
            for _ in range(len(batches)):
                batch = in_flight.pop(0).result()
                if next_submit < len(batches):
                    in_flight.append(pool.submit(self._make_batch, batches[next_submit]))
                    next_submit += 1
                yield self._hand_out(batch)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def setup_prefetch_loaders(batch_size=32, train_csv="", test_csv="", seed=0,
                           mesh=None, depth=3, workers=1, shard_index=0,
                           num_shards=1, transfer_dtype="float32", device=None):
    """Prefetching analogue of ``setup_data_loaders`` (same keys)."""
    train_dataset = FMRIDataset(train_csv)
    test_dataset = FMRIDataset(test_csv)
    kw = dict(mesh=mesh, depth=depth, workers=workers, shard_index=shard_index,
              num_shards=num_shards, transfer_dtype=transfer_dtype, device=device)
    return {
        "Shuffled_train": PrefetchLoader(train_dataset, batch_size, shuffle=True,
                                         seed=seed, **kw),
        "UnShuffled_train": PrefetchLoader(train_dataset, batch_size, shuffle=False, **kw),
        "test": PrefetchLoader(test_dataset, batch_size, shuffle=False, **kw),
    }
