"""Host-side statistical / file-format helpers.

The port's own copy of ``vaegam_tpu.utils.stats`` (importing any
``vaegam_tpu.utils`` module loads JAX).

Behavioral contracts from the reference:
  * zscore:           utils.py:113-123 (population sigma, all rows at once)
  * get_xu_ranges:    utils.py:39-56   (min/max +- 1e-3 over train+test csvs)
  * scale_beta_maps:  utils.py:170-178 (divide each map by its own max)
  * read_design_mat:  utils.py:153-168 (skip 5 FSL header lines, tab split)
  * mk_spherical_mask utils.py:126-151 (L1-ball => octahedral "spheres")
  * str2bool:         utils.py:59-73   (tri-state CLI boolean)
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import pandas as pd

MOTION_REGRESSORS = ["x", "y", "z", "rot_x", "rot_y", "rot_z"]


def zscore(df: pd.DataFrame) -> pd.DataFrame:
    """Z-score the six motion-regressor columns in place (population ddof=0).

    Statistics are computed over ALL rows (all volumes and subjects at once),
    matching the reference's global z-scoring.
    """
    for col in MOTION_REGRESSORS:
        col_vals = df[col]
        df[col] = (col_vals - col_vals.mean()) / col_vals.std(ddof=0)
    return df


def get_xu_ranges(csv_files, eps: float = 1e-3):
    """Per-motion-covariate [min-eps, max+eps] ranges over train+test CSVs.

    Used to place the fixed inducing-point grids for the six 1D GPs.
    """
    train_df = pd.read_csv(csv_files[0])
    test_df = pd.read_csv(csv_files[1])
    xu_ranges = []
    for reg in MOTION_REGRESSORS:
        min_val = min(train_df[reg].min(), test_df[reg].min())
        max_val = max(train_df[reg].max(), test_df[reg].max())
        xu_ranges.append([min_val - eps, max_val + eps])
    return xu_ranges


def str2bool(v):
    """Tri-state CLI boolean: bare flag => True; else parse common spellings."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def mk_spherical_mask(size: int, radius: int) -> np.ndarray:
    """size^3 binary mask, ones where L1 distance to center <= radius.

    The L1 metric is intentional (the reference's "spheres" are octahedra);
    the synthetic-signal control experiment's ground truth depends on it.
    """
    mask = np.zeros((size, size, size))
    c = int(np.floor(size / 2))
    x = np.arange(size)
    dist = (
        np.abs(x - c)[:, None, None]
        + np.abs(x - c)[None, :, None]
        + np.abs(x - c)[None, None, :]
    )
    mask[dist <= radius] = 1.0
    return mask


def read_design_mat(mat_file_path: str) -> np.ndarray:
    """Parse an FSL .feat design.mat: skip the 5 header lines, tab-separated."""
    with open(mat_file_path) as f:
        content = f.readlines()
    design_mat = []
    for line in content[5:]:
        stripped = line.rstrip()
        design_mat.append([float(tok) for tok in re.split(r"\t+", stripped)])
    return np.array(design_mat)


def scale_beta_maps(beta_maps: np.ndarray) -> np.ndarray:
    """Scale each beta map (row) by its own maximum value, in place."""
    for i in range(beta_maps.shape[0]):
        map_max = np.amax(beta_maps[i, :].flatten())
        beta_maps[i, :] = beta_maps[i, :] / map_max
    return beta_maps
