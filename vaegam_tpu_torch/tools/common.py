"""Shared pieces of the study tools: device sync, the CUDA-graph pool's
size, a synthetic NIfTI study, the one JSON line.

The package's main path does not import the tools; each tool imports what
it needs of this module.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def graph_pool_mib():
    """MiB of the caching allocator's segments that belong to a CUDA graph's
    private pool (None when the snapshot does not say which pool)."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) != (0, 0)) / 2**20


def emit(result: dict) -> dict:
    """Print a tool's result as one JSON line; returns it."""
    print(json.dumps(result), flush=True)
    return result


def build_dataset(root: str, n_subjs: int, n_vols: int, img_shape, first_subj: int,
                  name: str, seed: int = 0) -> str:
    """Synthetic subjects (one uncompressed 4D NIfTI each, values in the
    data's raw range) and the loader's CSV contract, as the JAX tools'
    ``build_dataset``; returns the CSV path."""
    import pandas as pd

    from ..utils import nifti

    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_subjs):
        subj = f"sub-A000{first_subj + s:02d}"
        vols = rng.uniform(0, 3284.5, size=tuple(img_shape) + (n_vols,)).astype(np.float32)
        path = os.path.join(root, f"{subj}.nii")
        nifti.save(nifti.Nifti1Image(vols, np.diag([2.0, 2.0, 2.0, 1.0])), path)
        for t in range(n_vols):
            rows.append([subj, t, path, float(t % 2), *rng.normal(size=6), s % 2])
    df = pd.DataFrame(rows, columns=["subjid", "volume #", "nii_path", "task", "x", "y",
                                     "z", "rot_x", "rot_y", "rot_z", "sex"])
    csv = os.path.join(root, name)
    df.to_csv(csv)
    return csv
