"""Synthetic control-signal injector CLI of the port.

Host-only (numpy, scipy); the port's own copy of ``vaegam_tpu.cli.add_signal``
(importing that module loads JAX), flag for flag the reference
add_control_signal.py (:32-43):
  --root_dir --intensity --shape --radius --size --nii_file_pattern

Behavioral contract:
  * shape == 'simple': four octahedral (L1) spheres added at the reference's
    frontal-lobe coordinates (add_control_signal.py:75-87);
  * any other shape: a binary 13x13 handwritten-style '3' broadcast over 10
    slices and inserted at [15:25, 34:47, 9:22] (:89-123).  The reference
    downloads MNIST via torchvision; this environment has no network and no
    torchvision, so an embedded 13x13 binary stencil of a '3' is used (the
    reference binarizes the digit to a 0/1 mask anyway — the stencil plays
    the same role as ground-truth signal for control experiments).  The
    `--stencil_file` extension accepts a user-supplied 13x13 binary .npy mask
    (e.g. the real binarized MNIST digit, producible offline with the
    reference's recipe) for exact voxel-for-voxel parity when available;
  * modulation by the control stimulus series (first block ON);
  * output written next to the original as
    {orig}_ALTERED_{shape}_{int}_simple_ts_{MM_DD_YYYY}.nii.gz, never
    overwriting the source (:149-154).  {orig} is the source path with
    ``rstrip(".nii.gz")`` applied, which strips a set of trailing
    characters, not the suffix; kept, so both packages name files alike.

    python -m vaegam_tpu_torch.cli.add_signal --root_dir D --intensity 400 \
        --shape simple
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from pathlib import Path

import numpy as np
from scipy import ndimage

from ..utils import nifti
from ..utils.signals import control_stimulus_to_neural
from ..utils.stats import mk_spherical_mask
from .preproc import discover_subjects

IMG_SHAPE = (41, 49, 35, 98)
TR = 1.4

# 13x13 binary '3' stencil (stands in for the binarized MNIST digit '3';
# reference add_control_signal.py:105-113 produces an equivalent 0/1 mask)
THREE_STENCIL = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0],
        [0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0],
        [0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0],
        [0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ],
    dtype=np.float64,
)


def build_parser():
    parser = argparse.ArgumentParser(
        description="user args for add_control_signal script."
    )
    parser.add_argument("--root_dir", type=str, metavar="N", default="",
                        help="Root dir where original .nii and .tsv files are located.")
    parser.add_argument("--intensity", type=float, metavar="N", default=1000,
                        help="Intensity of synthetic signal added to data.")
    parser.add_argument("--shape", type=str, metavar="N", default="simple",
                        help="Shape of signal added. Simple refers to 4 spheres. Any other str will yield a hand-written 3.")
    parser.add_argument("--radius", type=int, metavar="N", default=1,
                        help="Radius of spheres to be added. Only used if shape == simple.")
    parser.add_argument("--size", type=int, metavar="N", default=7,
                        help="Dim of 3D array containing spherical masks. This is an A*A*A cube. Only used if shape == simple")
    parser.add_argument("--nii_file_pattern", type=str, metavar="N",
                        default="sub-A000*_preproc_bold_brainmasked_resampled.nii.gz",
                        help="General pattern for filenames of nifti files to be used.")
    # Extension (not in the reference CLI): supply the exact 13x13 binary mask
    # for the shape != simple path -- e.g. the reference's binarized MNIST '3'
    # (add_control_signal.py:89-123: download -> resize 13x13 -> threshold
    # mean+0.85*std -> the injector rotates -90 deg) -- when data/network are
    # available.  Default: the embedded stencil.
    parser.add_argument("--stencil_file", type=str, metavar="N", default="",
                        help="Optional .npy path with a 13x13 binary (0/1) mask to use "
                             "instead of the embedded '3' stencil when shape != simple. "
                             "Use to reproduce the reference's binarized MNIST digit exactly.")
    # Extension: inject into non-reference grids (e.g. MNI 91x109x91,
    # BASELINE configs[4]); sphere placement scales proportionally
    # (scaled_sphere_params).  Default = the reference grid, exact behavior.
    parser.add_argument("--img_shape", type=int, metavar="N", nargs=3,
                        default=[41, 49, 35],
                        help="Volume grid (D H W) of the input niftis. Default 41 49 35 "
                             "(the reference grid, exact reference coordinates).")
    return parser


def load_stencil(stencil_file: str) -> np.ndarray:
    """Load + validate a user-supplied 13x13 binary stencil (.npy)."""
    stencil = np.load(stencil_file)
    if stencil.shape != (13, 13):
        raise ValueError(
            f"--stencil_file must be a 13x13 array, got {stencil.shape}"
        )
    uniq = np.unique(stencil)
    if not np.all(np.isin(uniq, (0, 1))):
        raise ValueError(
            f"--stencil_file must be binary (0/1), got values {uniq[:8]}"
        )
    return stencil.astype(np.float64)


# the four reference sphere-cube anchor corners on the (41,49,35) grid
# (add_control_signal.py:75-87)
_REF_GRID = (41, 49, 35)
_SPHERE_STARTS = ((15, 34, 14), (13, 38, 15), (20, 38, 15), (16, 38, 20))


def scaled_sphere_params(img_shape) -> tuple:
    """(starts, radius_scale) for a non-reference grid.

    Extension for BASELINE configs[4]-style grids (e.g. MNI 91x109x91):
    sphere anchor corners scale proportionally with the grid and the L1
    radius scales with the mean linear factor, so the injected signal keeps
    the same relative frontal-lobe placement.  On the reference grid this
    returns the reference's exact coordinates and radius_scale 1.
    """
    f = [s / r for s, r in zip(img_shape[:3], _REF_GRID)]
    starts = tuple(
        tuple(int(round(c * fi)) for c, fi in zip(st, f))
        for st in _SPHERE_STARTS
    )
    radius_scale = max(1, int(round(sum(f) / 3.0)))
    return starts, radius_scale


def build_control_signal(shape: str, intensity: float, radius: int,
                         size: int, img_shape=IMG_SHAPE,
                         stencil: np.ndarray | None = None) -> np.ndarray:
    control_sig = np.zeros((img_shape[0], img_shape[1], img_shape[2]))
    if shape == "simple":
        starts, rscale = scaled_sphere_params(img_shape)
        spherical_mask = intensity * mk_spherical_mask(
            size=size, radius=radius * rscale
        )
        for (a, b, c) in starts:
            # clip-safe insert: a no-op on the reference grid (all four
            # cubes fit, add_control_signal.py:84-87 exactly); on very
            # small grids (sub-reference oracle smoke runs) the scaled
            # anchors can touch the boundary and the mask is cropped
            blk = control_sig[a:a + size, b:b + size, c:c + size]
            blk += spherical_mask[: blk.shape[0], : blk.shape[1],
                                  : blk.shape[2]]
    else:
        sig = intensity * (THREE_STENCIL if stencil is None else stencil)
        rot_sig = ndimage.rotate(sig, -90)
        signal = np.broadcast_to(rot_sig, (10, 13, 13))
        control_sig[15:25, 34:47, 9:22] += signal
    return control_sig


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.root_dir == "":
        args.root_dir = os.getcwd()
    elif not os.path.exists(args.root_dir):
        print("Root dir given does not exist!")
        sys.exit(1)

    subjs = discover_subjects(args.root_dir)
    raw_data_files = []
    for subj in subjs:
        full_path = os.path.join(args.root_dir, subj)
        for data_file in Path(full_path).rglob(args.nii_file_pattern):
            raw_data_files.append(str(data_file))

    stencil = load_stencil(args.stencil_file) if args.stencil_file else None
    control_sig = build_control_signal(
        args.shape, args.intensity, args.radius, args.size,
        img_shape=tuple(args.img_shape), stencil=stencil
    )

    ts = datetime.datetime.now().date()
    intensity_as_str = str(int(args.intensity))
    written = []
    for original_path in raw_data_files:
        orig_nii = nifti.load(original_path)
        orig = np.array(orig_nii.dataobj)
        n_vols = orig.shape[3]
        vol_times = np.arange(1, n_vols + 1) * TR
        neural = control_stimulus_to_neural(vol_times)
        # vectorized: add the signal to every ON volume at once
        altered_data = orig + control_sig[..., None] * neural[None, None, None, :]
        alt_path = (
            original_path.rstrip(".nii.gz")
            + "_ALTERED_" + args.shape + "_" + intensity_as_str
            + "_simple_ts_" + ts.strftime("%m_%d_%Y") + ".nii.gz"
        )
        nifti.save(
            nifti.Nifti1Image(altered_data, orig_nii.affine, orig_nii.header),
            alt_path,
        )
        written.append(alt_path)
        print(alt_path)
    return written


if __name__ == "__main__":
    main()
