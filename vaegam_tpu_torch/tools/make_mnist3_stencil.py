"""The 13x13 binarized MNIST-'3' stencil, by the reference's recipe.

Counterpart of ``vaegam_tpu.tools.make_mnist3_stencil``, host only (numpy
and PIL); it downloads nothing.  The reference's shape != 'simple' control
signal (add_control_signal.py:89-123) takes MNIST train index 7 (the first
'3'), resizes it to 13x13 with PIL's default filter for mode 'L'
(BICUBIC, :106), divides by 255 and thresholds at mean + 0.85 * std
(population std, :109-113).  The 28x28 digit comes in as a uint8 .npy:

    python -m vaegam_tpu_torch.tools.make_mnist3_stencil \\
        --raw_digit tests/golden/raw_digit3_28x28.npy --out mnist3_stencil.npy

On the committed stand-in digit this reproduces
tests/golden/mnist3_binary_stencil.npy; on the true digit bytes, the
reference's mask.  Prints one JSON line.
"""

from __future__ import annotations

import argparse

import numpy as np

from .common import emit


def binarize_digit(raw_28x28: np.ndarray) -> np.ndarray:
    """The recipe's resize and threshold: a 28x28 uint8 digit -> the 13x13
    int 0/1 mask (before the injector's -90 degree rotation, :117)."""
    from PIL import Image

    if raw_28x28.shape != (28, 28):
        raise ValueError(f"expected a 28x28 digit, got {raw_28x28.shape}")
    img = Image.fromarray(np.asarray(raw_28x28, np.uint8), mode="L")
    norm_three = np.asarray(img.resize((13, 13))) / 255
    sig_mean = np.mean(norm_three.flatten())
    sig_std = np.std(norm_three.flatten())
    return np.where(norm_three.flatten() > (sig_mean + 0.85 * sig_std), 1, 0
                    ).reshape(norm_three.shape)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--raw_digit", required=True,
                   help="28x28 uint8 .npy of the digit (MNIST train index 7)")
    p.add_argument("--out", required=True, help="output .npy for the 13x13 0/1 stencil")
    args = p.parse_args(argv)
    stencil = binarize_digit(np.load(args.raw_digit))
    np.save(args.out, stencil.astype(np.uint8))
    return emit({"tool": "make_mnist3_stencil", "out": args.out,
                 "voxels_on": int(stencil.sum()), "shape": list(stencil.shape)})


if __name__ == "__main__":
    main()
