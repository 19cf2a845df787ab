"""Device-resident dataset: all volumes and covariates on the card at once.

Counterpart of the part of ``vaegam_tpu.data.device_cache`` the fused train
step needs: the whole (N, D, H, W) volume stack and the (N, C) covariates
are uploaded once, and each step gathers its batch on the device by index.
The batch order is the JAX loader's: ``np.random.default_rng((seed, epoch))``
after ``set_epoch``, so both packages visit the same batches.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device


class DeviceResidentLoader:
    def __init__(self, volumes: np.ndarray, covariates: np.ndarray,
                 batch_size: int = 32, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device=None):
        device = resolve_device(device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch: Optional[int] = None
        self.vols = torch.as_tensor(np.asarray(volumes, np.float32), device=device)
        self.covs = torch.as_tensor(np.asarray(covariates, np.float32), device=device)
        if len(self.vols) != len(self.covs):
            raise ValueError("volumes and covariates differ in length")

    @classmethod
    def from_arrays(cls, volumes, covariates, **kwargs) -> "DeviceResidentLoader":
        """Build a loader from in-memory arrays (volumes (N,D,H,W), covariates (N,C))."""
        return cls(volumes, covariates, **kwargs)

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
        """(covariates, volumes) rows `sel`, gathered on the device."""
        idx = torch.as_tensor(np.asarray(sel), device=self.vols.device)
        return self.covs.index_select(0, idx), self.vols.index_select(0, idx)
