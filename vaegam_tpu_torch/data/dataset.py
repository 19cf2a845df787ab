"""CSV-driven fMRI dataset and its streaming batch loader (host side).

Counterpart of ``vaegam_tpu.data.dataset`` (reference DataClass_GP.py),
with the same sample contract, CSV schema and batch order:
  * each item is a dict: covariates (8,) float32 [task, x, y, z, rot_x,
    rot_y, rot_z, sex]; volume (D, H, W) float32 divided by the global
    scale 3284.5; subjid, the subject's index in order of first appearance;
    vol_num, the volume's index in its subject's 4D series;
  * the CSV is read by position: [index, subjid, "volume #", nii_path, task,
    x, y, z, rot_x, rot_y, rot_z, sex];
  * each 4D file is decoded once and memoized in a bounded LRU;
  * the shuffle after ``set_epoch(k)`` is ``np.random.default_rng((seed, k))``.
Batches are numpy arrays of the global batch; the Trainer moves them to
the card (a data-parallel Trainer its own rows of the volumes).
``shard_index``/``num_shards`` restrict a loader to the rows
[shard_index::num_shards], as in the JAX package; its ``num_samples``
stays the dataset's length, the per-epoch loss denominator.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator

import numpy as np
import pandas as pd

from ..utils import nifti_native

# global intensity scale across all volumes (DataClass_GP.py:49)
GLOBAL_SCALE = 3284.5

_COVARIATE_COLS = 4 + np.arange(8)  # task,x,y,z,rot_x,rot_y,rot_z,sex (iloc)


def check_row_sharding(mesh, num_shards: int) -> None:
    """Refuse row sharding under a multi-process mesh (JAX's rule)."""
    if mesh is not None and mesh.world > 1 and num_shards > 1:
        raise ValueError(
            "row sharding (num_shards>1) cannot compose with a multi-process "
            "mesh: every rank must hold the same rows; each rank holds the "
            "whole dataset instead")


class _VolumeCache:
    """Bounded LRU cache of decoded 4D NIfTI arrays, keyed by path.

    Thread-safe, as the JAX package's: the lock is not held across the
    decode; a duplicate concurrent decode of one path is benign.
    ``decode_seconds`` sums the host time of the decodes made through it.
    """

    def __init__(self, max_items: int = 32):
        self.max_items = max_items
        self.decode_seconds = 0.0
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str) -> np.ndarray:
        with self._lock:
            arr = self._cache.get(path)
            if arr is not None:
                self._cache.move_to_end(path)
                return arr
        t0 = time.perf_counter()
        arr = nifti_native.decode_f32(path)  # native C++ path w/ fallback
        self.decode_seconds += time.perf_counter() - t0
        self.put(path, arr)
        return arr

    def put(self, path: str, arr: np.ndarray) -> None:
        with self._lock:
            self._cache[path] = arr
            self._cache.move_to_end(path)
            while len(self._cache) > self.max_items:
                self._cache.popitem(last=False)

    def trim(self, max_items: int) -> None:
        with self._lock:
            self.max_items = max_items
            while len(self._cache) > max_items:
                self._cache.popitem(last=False)

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, path: str) -> bool:
        return path in self._cache


class FMRIDataset:
    """Per-volume samples backed by a design CSV."""

    def __init__(self, csv_file: str, scale: float = GLOBAL_SCALE,
                 cache_items: int = 32):
        self.df = pd.read_csv(csv_file)
        self.scale = np.float32(scale)
        self._cache = _VolumeCache(cache_items)
        self._default_cache_items = cache_items
        # subject index by order of first appearance (DataClass_GP.py:31-33)
        self._unique_subjs = self.df.subjid.unique().tolist()
        self._subj_idx = np.array(
            [self._unique_subjs.index(s) for s in self.df.iloc[:, 1]],
            dtype=np.int64,
        )
        self._vol_nums = self.df.iloc[:, 2].to_numpy(dtype=np.int64)
        self._nii_paths = self.df.iloc[:, 3].astype(str).to_numpy()
        self._covariates = self.df.iloc[:, _COVARIATE_COLS].to_numpy(
            dtype=np.float32
        )

    def __len__(self) -> int:
        return len(self.df)

    @property
    def unique_subjs(self):
        return list(self._unique_subjs)

    @property
    def decode_seconds(self) -> float:
        """Host seconds spent decoding this dataset's NIfTI files so far."""
        return self._cache.decode_seconds

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        fmri = self._cache.get(self._nii_paths[idx])
        vol_num = int(self._vol_nums[idx])
        volume = fmri[:, :, :, vol_num] / self.scale
        return {
            "covariates": self._covariates[idx],
            "volume": volume.astype(np.float32),
            "subjid": self._subj_idx[idx],
            "vol_num": np.int64(vol_num),
        }

    def meta(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        """The rows' covariates, subject indices and volume numbers, without
        decoding a volume."""
        return {"covariates": self._covariates[idxs],
                "subjid": self._subj_idx[idxs],
                "vol_num": self._vol_nums[idxs]}

    def prewarm(self, rows: np.ndarray = None, n_threads: int = 0) -> None:
        """Decode every distinct subject file for `rows` in ONE parallel pass
        (the native thread pool), growing the LRU to hold them all until
        :meth:`trim_cache`.  Whole-dataset builds use
        ``gather(chunk_files=...)`` instead, which bounds host memory."""
        paths = self._nii_paths if rows is None else self._nii_paths[rows]
        todo = [p for p in dict.fromkeys(paths) if p not in self._cache]
        if not todo:
            return
        self._cache.max_items = max(
            self._cache.max_items, len(self._cache) + len(todo)
        )
        t0 = time.perf_counter()
        decoded = nifti_native.decode_many_f32(todo, n_threads)
        self._cache.decode_seconds += time.perf_counter() - t0
        for p, arr in zip(todo, decoded):
            self._cache.put(p, arr)

    def trim_cache(self) -> None:
        """Restore the LRU budget a :meth:`prewarm` grew (evicting oldest)."""
        self._cache.trim(self._default_cache_items)

    def gather(self, idxs: np.ndarray,
               chunk_files: int = 0) -> Dict[str, np.ndarray]:
        """Materialize one batch as stacked arrays.

        ``chunk_files > 0`` bounds host RAM for whole-dataset gathers
        (device-cache builds): subject files are decoded in parallel chunks
        of that many files and released once their rows are copied, so the
        peak is the stacked copy plus one chunk of decoded 4D files.  Files
        already in the LRU are reused; cold files decoded this way are not
        inserted into it.
        """
        vols = np.empty((len(idxs),) + self[0]["volume"].shape, np.float32)
        if chunk_files > 0:
            by_file: Dict[str, list] = {}
            for k, i in enumerate(idxs):
                by_file.setdefault(self._nii_paths[i], []).append(k)
            files = list(by_file)
            for lo in range(0, len(files), chunk_files):
                chunk = files[lo:lo + chunk_files]
                todo = [p for p in chunk if p not in self._cache]
                t0 = time.perf_counter()
                decoded = dict(zip(todo, nifti_native.decode_many_f32(todo))) \
                    if todo else {}
                self._cache.decode_seconds += time.perf_counter() - t0
                for p in chunk:
                    fmri = decoded.get(p)
                    if fmri is None:
                        fmri = self._cache.get(p)
                    for k in by_file[p]:
                        vols[k] = fmri[:, :, :, self._vol_nums[idxs[k]]]
        else:
            for k, i in enumerate(idxs):
                fmri = self._cache.get(self._nii_paths[i])
                vols[k] = fmri[:, :, :, self._vol_nums[i]]
        vols /= self.scale
        return {
            "covariates": self._covariates[idxs],
            "volume": vols,
            "subjid": self._subj_idx[idxs],
            "vol_num": self._vol_nums[idxs],
        }


class DataLoader:
    """Batched iterator over an FMRIDataset (numpy batches).

    shuffle=True reshuffles every epoch, torch RandomSampler semantics as in
    the reference (DataClass_GP.py:77-87); after ``set_epoch`` the order is
    a pure function of (seed, epoch), so a resumed run repeats an unbroken
    run's order.  ``shard_index``/``num_shards`` iterate the rows
    [shard_index::num_shards] only.
    """

    def __init__(
        self,
        dataset: FMRIDataset,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._epoch = None
        self._rows = np.arange(len(dataset))[shard_index::num_shards]

    def __len__(self) -> int:
        n = len(self._rows)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Derive the next iteration's shuffle from (seed, epoch) instead of
        the stateful stream (the DistributedSampler.set_epoch idiom)."""
        self._epoch = int(epoch)

    def _epoch_rng(self):
        if self._epoch is not None:
            return np.random.default_rng((self._seed, self._epoch))
        return self._rng

    @property
    def num_samples(self) -> int:
        """Sample count: the per-epoch loss denominator (the reference's
        len(dataset), vae_reg_GP.py:430)."""
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rows.copy()
        if self.shuffle:
            self._epoch_rng().shuffle(order)
        for start in range(0, len(order), self.batch_size):
            batch = order[start : start + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield self.dataset.gather(batch)


def setup_data_loaders(
    batch_size: int = 32,
    shuffle=(True, False, False),
    train_csv: str = "",
    test_csv: str = "",
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
) -> Dict[str, DataLoader]:
    """Three loaders keyed exactly like the reference (DataClass_GP.py:73-89):
    Shuffled_train (training), UnShuffled_train (plots/recons), test."""
    train_dataset = FMRIDataset(train_csv)
    test_dataset = FMRIDataset(test_csv)
    shard = dict(shard_index=shard_index, num_shards=num_shards)
    return {
        "Shuffled_train": DataLoader(train_dataset, batch_size,
                                     shuffle=shuffle[0], seed=seed, **shard),
        "UnShuffled_train": DataLoader(train_dataset, batch_size,
                                       shuffle=shuffle[1], **shard),
        "test": DataLoader(test_dataset, batch_size, shuffle=shuffle[2], **shard),
    }
