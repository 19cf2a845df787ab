"""Device-resident dataset: all volumes and covariates on the card at once.

Counterpart of ``vaegam_tpu.data.device_cache`` without its mesh and
multi-process branches (ROADMAP module item 10): the whole (N, D, H, W)
volume stack and the (N, C) covariates are decoded on the host, uploaded
once, and each step gathers its batch on the device by index.  The batch
order is the JAX loader's: ``np.random.default_rng((seed, epoch))`` after
``set_epoch``, so both packages visit the same batches.

Cache precision: ``cache_dtype`` "bfloat16"/"float16" stores the volumes at
half the bytes (round to nearest even) and ``gather`` restores float32.
The /3284.5-scaled volumes lie in [0, 1], where float16 quantizes 8x finer
than bfloat16 at the same cost, so ``setup_device_loaders``' "auto" picks
float32 when it fits the budget and float16 otherwise.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from .dataset import FMRIDataset, check_no_row_sharding

DEFAULT_MAX_BYTES = 4 << 30  # refuse to cache datasets larger than 4 GiB

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _cache_bytes(dataset: FMRIDataset, cache_dtype: str) -> int:
    return len(dataset) * dataset[0]["volume"].size * _CACHE_DTYPES[cache_dtype].itemsize


class DeviceResidentLoader:
    """Iterates ``{volume, covariates, subjid, vol_num}`` batches gathered
    on the device (volume and covariates as float32 device tensors, subjid
    and vol_num as host numpy for the output writers), and hands
    index batches to the Trainer's gather-fused step
    (``iter_index_batches`` + ``gather``, or ``upload_indices`` +
    ``gather_index`` under ``epoch_scan``).

    ``build_seconds`` records the cold start: the dataset's host decode
    (budget check included) and the upload.
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
        _arrays: Optional[dict] = None,
    ):
        check_no_row_sharding(shard_index, num_shards)
        device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch: Optional[int] = None
        self.cache_dtype = _CACHE_DTYPES[str(cache_dtype)]

        if _arrays is not None:  # from_arrays path
            host = _arrays
        else:
            nbytes = _cache_bytes(dataset, str(cache_dtype))
            if nbytes > max_bytes:
                raise ValueError(
                    f"dataset needs {nbytes >> 20} MiB on device, over the "
                    f"{max_bytes >> 20} MiB cache limit — use a streaming "
                    "loader instead"
                )
            # chunked parallel decode (native thread pool): 16 subject files
            # at a time, released once their rows land in the stacked array
            host = dataset.gather(np.arange(len(dataset)), chunk_files=16)
        t1 = time.perf_counter()
        vols = torch.from_numpy(np.ascontiguousarray(host["volume"], np.float32))
        self.vols = vols.to(self.cache_dtype).to(device)
        self.covs = torch.from_numpy(
            np.ascontiguousarray(host["covariates"], np.float32)).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_seconds = {"decode": 0.0 if dataset is None else dataset.decode_seconds,
                              "upload": time.perf_counter() - t1}
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

    @property
    def num_samples(self) -> int:
        """Sample count: the per-epoch loss denominator."""
        return len(self.vols)

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
        """(covariates, volumes as float32) rows `sel`, gathered on the device."""
        return self.gather_index(torch.as_tensor(np.asarray(sel), device=self.vols.device))

    def gather_index(self, idx):
        """:meth:`gather` for rows given as an index tensor on the cache's
        device."""
        return (self.covs.index_select(0, idx),
                self.vols.index_select(0, idx).float())

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
                         max_bytes=DEFAULT_MAX_BYTES, device=None):
    """Device-resident analogue of ``setup_data_loaders`` (same keys).

    cache_dtype="auto" caches float32 when both datasets fit ``max_bytes``
    and float16 when only that fits; "float32"/"bfloat16"/"float16" force a
    precision.  The budget is checked before any decode or upload.  When the
    train and test CSVs are the same file, one cache serves all three
    loaders.  Raises ValueError when nothing fits (callers fall back to the
    streaming loader).
    """
    check_no_row_sharding(shard_index, num_shards)
    device = resolve_device(device)
    train_dataset = FMRIDataset(train_csv)
    test_dataset = FMRIDataset(test_csv)
    dtypes = ["float32", "float16"] if cache_dtype == "auto" else [cache_dtype]
    for dt in dtypes:
        if max(_cache_bytes(train_dataset, dt),
               _cache_bytes(test_dataset, dt)) > max_bytes:
            continue
        kw = dict(cache_dtype=dt, max_bytes=max_bytes, device=device)
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
