"""Device-resident dataset: all volumes and covariates on the card at once.

Counterpart of ``vaegam_tpu.data.device_cache``: the whole (N, D, H, W)
volume stack and the (N, C) covariates are decoded on the host, uploaded
once, and each step gathers its batch on the device by index.  The batch
order is the JAX loader's: ``np.random.default_rng((seed, epoch))`` after
``set_epoch``, so both packages visit the same batches.

Data parallel (``mesh``): every rank decodes and holds the WHOLE cache, as
the JAX loader replicates it over its mesh, and walks the same seeded
order; a gather returns the global batch's covariates and this rank's
block of its volumes (``parallel.batch_rows``; a batch the ranks do not
divide splits unevenly, as XLA splits the JAX loader's in-jit gather).
Row sharding (``shard_index``/``num_shards``: the rows
[shard_index::num_shards] only) is refused under a multi-process mesh, as
in the JAX package: each rank's cache must hold the same rows.

Cache precision: ``cache_dtype`` "bfloat16"/"float16" stores the volumes at
half the bytes (round to nearest even) and ``gather`` restores float32.
The /3284.5-scaled volumes lie in [0, 1], where float16 quantizes 8x finer
than bfloat16 at the same cost, so ``setup_device_loaders``' "auto" picks
float32 when it fits the budget and float16 otherwise.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import batch_rows
from ..utils import spans
from .dataset import FMRIDataset, check_row_sharding

DEFAULT_MAX_BYTES = 4 << 30  # refuse to cache datasets larger than 4 GiB

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _cache_bytes(dataset: FMRIDataset, cache_dtype: str, shard_index=0,
                 num_shards=1) -> int:
    rows = len(range(shard_index, len(dataset), num_shards))
    return rows * dataset[0]["volume"].size * _CACHE_DTYPES[cache_dtype].itemsize


class DeviceResidentLoader:
    """Iterates ``{volume, covariates, subjid, vol_num}`` batches gathered
    on the device (volume and covariates as float32 device tensors, subjid
    and vol_num as host numpy for the output writers), and hands
    index batches to the Trainer's gather-fused step
    (``iter_index_batches`` + ``gather``, or ``upload_indices`` +
    ``gather_index`` under ``epoch_scan``).  Under a ``mesh`` a batch's
    volume holds this rank's rows of it (module docstring).

    ``build_seconds`` records the cold start: the dataset's host decode
    (budget check included) and the upload (the ``cache.upload`` span's
    seconds).
    """

    def __init__(
        self,
        dataset: Optional[FMRIDataset],
        batch_size: int = 32,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        max_bytes: int = DEFAULT_MAX_BYTES,
        shard_index: int = 0,
        num_shards: int = 1,
        cache_dtype: str = "float32",
        device=None,
        mesh=None,
        _arrays: Optional[dict] = None,
    ):
        check_row_sharding(mesh, num_shards)
        device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch: Optional[int] = None
        self.cache_dtype = _CACHE_DTYPES[str(cache_dtype)]

        # the per-epoch loss denominator: the dataset's length, whatever rows
        # this cache holds (JAX's num_samples)
        self.num_samples = len(dataset if _arrays is None else _arrays["volume"])
        rows = np.arange(self.num_samples)[shard_index::num_shards]
        if _arrays is not None:  # from_arrays path
            host = _arrays
            if num_shards > 1:
                host = {k: np.asarray(v)[rows] for k, v in host.items()}
        else:
            nbytes = _cache_bytes(dataset, str(cache_dtype), shard_index, num_shards)
            if nbytes > max_bytes:
                raise ValueError(
                    f"dataset needs {nbytes >> 20} MiB on device, over the "
                    f"{max_bytes >> 20} MiB cache limit — use a streaming "
                    "loader instead"
                )
            # chunked parallel decode (native thread pool): 16 subject files
            # at a time, released once their rows land in the stacked array
            host = dataset.gather(rows, chunk_files=16)
        with spans.timed("cache.upload") as upload:
            vols = torch.from_numpy(np.ascontiguousarray(host["volume"], np.float32))
            self.vols = vols.to(self.cache_dtype).to(device)
            self.covs = torch.from_numpy(
                np.ascontiguousarray(host["covariates"], np.float32)).to(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.build_seconds = {"decode": 0.0 if dataset is None else dataset.decode_seconds,
                              "upload": upload.seconds}
        if len(self.vols) != len(self.covs):
            raise ValueError("volumes and covariates differ in length")
        self._subjid = np.asarray(host["subjid"])
        self._vol_nums = np.asarray(host["vol_num"])

    @classmethod
    def sharing_cache(cls, other: "DeviceResidentLoader", batch_size=None,
                      shuffle=False, seed=0,
                      drop_last=False) -> "DeviceResidentLoader":
        """A second view over an existing loader's device cache (no second
        upload): Shuffled_train and UnShuffled_train iterate one dataset."""
        self = cls.__new__(cls)
        self.__dict__.update(other.__dict__)
        self.batch_size = batch_size if batch_size is not None else other.batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = None
        return self

    @classmethod
    def from_arrays(cls, volumes, covariates, subjid=None, vol_nums=None,
                    **kwargs) -> "DeviceResidentLoader":
        """Build a loader from in-memory arrays (volumes (N,D,H,W),
        covariates (N,C)); the iteration contract is the dataset-backed one."""
        n = len(volumes)
        arrays = {
            "volume": volumes,
            "covariates": covariates,
            "subjid": subjid if subjid is not None else np.zeros(n, np.int64),
            "vol_num": vol_nums if vol_nums is not None else np.arange(n),
        }
        return cls(None, _arrays=arrays, **kwargs)

    def __len__(self) -> int:
        n = len(self.vols)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Make the next shuffle a pure function of (seed, epoch)."""
        self._epoch = int(epoch)

    def _epoch_rng(self):
        if self._epoch is not None:
            return np.random.default_rng((self._seed, self._epoch))
        return self._rng

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """Yield per-batch index arrays (host numpy) for gather-fused steps."""
        order = np.arange(len(self.vols))
        if self.shuffle:
            self._epoch_rng().shuffle(order)
        for start in range(0, len(order), self.batch_size):
            sel = order[start: start + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                return
            yield sel

    def gather(self, sel):
        """(covariates, volumes as float32) of rows `sel`, gathered on the
        device; under a mesh the covariates of all of them and the volumes
        of this rank's block."""
        return self.gather_index(torch.as_tensor(np.asarray(sel), device=self.vols.device))

    def gather_index(self, idx):
        """:meth:`gather` for rows given as an index tensor on the cache's
        device."""
        lo, hi = batch_rows(len(idx), self.mesh, uneven=True)
        return (self.covs.index_select(0, idx),
                self.vols.index_select(0, idx[lo:hi]).float())

    def upload_indices(self, sels):
        """An epoch's index batches, concatenated in order, as one int64
        tensor on the cache's device: a single copy from pinned memory that
        does not block the host (the Trainer's ``epoch_scan`` epochs slice
        it, one step's rows at a time)."""
        flat = torch.from_numpy(np.concatenate(sels).astype(np.int64))
        if self.vols.is_cuda:
            return flat.pin_memory().to(self.vols.device, non_blocking=True)
        return flat.to(self.vols.device)

    def __iter__(self) -> Iterator[dict]:
        for sel in self.iter_index_batches():
            covs, vols = self.gather(sel)
            yield {"volume": vols, "covariates": covs,
                   "subjid": self._subjid[sel], "vol_num": self._vol_nums[sel]}


def setup_device_loaders(batch_size=32, train_csv="", test_csv="", seed=0,
                         shard_index=0, num_shards=1, cache_dtype="auto",
                         max_bytes=DEFAULT_MAX_BYTES, device=None, mesh=None):
    """Device-resident analogue of ``setup_data_loaders`` (same keys).

    cache_dtype="auto" caches float32 when both datasets fit ``max_bytes``
    and float16 when only that fits; "float32"/"bfloat16"/"float16" force a
    precision.  The budget is checked before any decode or upload.  When the
    train and test CSVs are the same file, one cache serves all three
    loaders.  Raises ValueError when nothing fits (callers fall back to the
    streaming loader).
    """
    check_row_sharding(mesh, num_shards)
    train_dataset = FMRIDataset(train_csv)
    test_dataset = FMRIDataset(test_csv)
    dtypes = ["float32", "float16"] if cache_dtype == "auto" else [cache_dtype]
    shard = dict(shard_index=shard_index, num_shards=num_shards)
    for dt in dtypes:
        if max(_cache_bytes(train_dataset, dt, **shard),
               _cache_bytes(test_dataset, dt, **shard)) > max_bytes:
            continue
        kw = dict(cache_dtype=dt, max_bytes=max_bytes, device=device, mesh=mesh, **shard)
        shuffled = DeviceResidentLoader(train_dataset, batch_size, shuffle=True,
                                        seed=seed, **kw)
        if os.path.realpath(train_csv) == os.path.realpath(test_csv):
            test = DeviceResidentLoader.sharing_cache(shuffled, batch_size)
        else:
            test = DeviceResidentLoader(test_dataset, batch_size, **kw)
        if dt != "float32" and cache_dtype == "auto":
            print(f"[device cache] dataset exceeds the float32 device budget — "
                  f"caching {dt} (float32 restored in the gather)")
        return {
            "Shuffled_train": shuffled,
            "UnShuffled_train": DeviceResidentLoader.sharing_cache(shuffled,
                                                                   batch_size),
            "test": test,
        }
    raise ValueError(f"dataset exceeds the {max_bytes >> 20} MiB device cache "
                     f"budget at {dtypes[-1]} — use a streaming loader "
                     "instead")
