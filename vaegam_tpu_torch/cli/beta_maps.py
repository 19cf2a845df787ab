"""GLM beta-map regularizer builder CLI of the port.

Flag for flag ``vaegam_tpu.cli.beta_maps`` (reference
get_beta_map_regularizer.py:18-25: --root_dir --output_dir --data_dims
--sex_covars_map, and the --solve_dtype extension), plus ``--device``
(default: the CUDA device; ``cpu`` runs on the CPU).

Behavioral contract (get_beta_map_regularizer.py:47-107):
  * subject discovery like preproc; one *_corrected.feat dir per subject;
  * stack filtered_func_data.nii.gz into (voxels, sum_T);
  * per-subject FSL design.mat -> [task col | last 6 motion cols];
  * solve the GLM beta = argmin ||G beta - Y^T||;
  * append the sex cope map, max-scale each map, write
    scld_GLM_beta_maps.csv with columns [task,x,y,z,xrot,yrot,zrot,sex].

The float64 solve (the default) is numpy's lstsq on the host, as the JAX
package's; ``--solve_dtype float32`` solves with ``torch.linalg.lstsq`` on
the device, where the JAX package solves with ``jnp.linalg.lstsq``.

    python -m vaegam_tpu_torch.cli.beta_maps --root_dir D --output_dir O \\
        --data_dims 41 49 35 98 --sex_covars_map M [--solve_dtype float32]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from .._device import resolve_device
from ..utils import nifti
from ..utils.stats import read_design_mat, scale_beta_maps
from .preproc import discover_subjects


def build_parser():
    parser = argparse.ArgumentParser(
        description="user args for beta map regularization script."
    )
    parser.add_argument("--root_dir", type=str, metavar="N", default="",
                        help="Root directory containing subdirs for each subject and for .feat FSL analysis for each subject.")
    parser.add_argument("--output_dir", type=str, metavar="N", default="",
                        help="Output where resulting .csv file with beta maps should be written to.")
    parser.add_argument("--data_dims", type=int, metavar="N", default="",
                        nargs="+",
                        help="Dimensions for fMRI data being processed. Should be in order x, y, z, time.")
    parser.add_argument("--sex_covars_map", type=str, metavar="N", default="",
                        help="Full path to sex covariate cope map produced in higher level analysis in FSL.")
    parser.add_argument("--solve_dtype", type=str, metavar="N",
                        default="float64", choices=["float32", "float64"],
                        help="Precision of the GLM solve. float64 (default) runs the "
                             "reference-parity host solve; float32 runs on device.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device of the float32 solve (default: the CUDA device; "
                             "'cpu' runs on the CPU).")
    return parser


def solve_beta_maps(gamma: np.ndarray, filtered_data: np.ndarray,
                    dtype: str = "float64", device=None) -> np.ndarray:
    """beta = argmin ||gamma @ beta - Y^T||^2, batched over voxels.

    dtype='float64' (default): numpy lstsq on the host at the reference's
    precision (get_beta_map_regularizer.py:94-96 solves the normal equations
    in float64; lstsq agrees whenever G^T G is invertible, which it assumes).
    dtype='float32': ``torch.linalg.lstsq`` on `device` (QR; the design is
    tall and full rank), returned as float64.
    """
    if dtype == "float64":
        sol, *_ = np.linalg.lstsq(
            gamma.astype(np.float64),
            filtered_data.T.astype(np.float64),
            rcond=None,
        )
        return sol
    device = resolve_device(device)
    g = torch.as_tensor(np.asarray(gamma, np.float32), device=device)
    y = torch.as_tensor(np.ascontiguousarray(filtered_data.T, np.float32), device=device)
    sol = torch.linalg.lstsq(g, y).solution
    return sol.cpu().numpy().astype(np.float64)


def main(argv=None):
    args = build_parser().parse_args(argv)
    data_dims = args.data_dims
    # the device is resolved before any work: no card and no --device cpu raises
    device = resolve_device(args.device)

    if not os.path.exists(args.root_dir):
        print("Root dir given does not exist!")
        print("Cannot proceed w/out data!")
        sys.exit(1)
    if args.output_dir == "":
        args.output_dir = os.getcwd()
    elif not os.path.exists(args.output_dir):
        os.makedirs(args.output_dir)

    subjs = discover_subjects(args.root_dir)
    assert len(subjs) != 0, (
        "Could not find any subjID matching expected pattern on root dir."
    )

    feat_dirs = [
        str(d)
        for subj in subjs
        for d in Path(os.path.join(args.root_dir, subj)).rglob(
            "*_corrected.feat"
        )
    ]
    assert len(subjs) == len(feat_dirs), "Not all subjs have .feat directories!"

    # one pass per subject: (T, 7) design block [task | 6 motion] and the
    # (voxels, T) filtered BOLD block; stacked time-wise across subjects
    n_t = data_dims[3]
    design_blocks, bold_blocks = [], []
    for subj, feat in zip(subjs, feat_dirs):
        bold_path = os.path.join(feat, "filtered_func_data.nii.gz")
        assert os.path.exists(bold_path), (
            f"Failed to find filtered data for subj {subj}"
        )
        bold_blocks.append(
            np.asarray(nifti.load(bold_path).dataobj).reshape(-1, n_t)
        )
        dm_path = os.path.join(feat, "design.mat")
        assert os.path.exists(dm_path), (
            f"Failed to find design matrix for subj {subj}"
        )
        dm = read_design_mat(dm_path)
        design_blocks.append(
            np.column_stack([dm[:, 0].reshape(n_t), dm[:, -6:]])
        )

    beta_maps = solve_beta_maps(
        np.concatenate(design_blocks, axis=0),       # (sum_T, 7)
        np.concatenate(bold_blocks, axis=1),         # (voxels, sum_T)
        dtype=args.solve_dtype,
        device=device,
    )

    sex_map = np.asarray(nifti.load(args.sex_covars_map).dataobj)
    with_sex = np.vstack([beta_maps, sex_map.reshape(1, -1)])

    out = os.path.join(args.output_dir, "scld_GLM_beta_maps.csv")
    pd.DataFrame(
        scale_beta_maps(with_sex).T,
        columns=["task", "x", "y", "z", "xrot", "yrot", "zrot", "sex"],
    ).to_csv(out)
    print(out)
    return out


if __name__ == "__main__":
    main()
