"""Subpixel (polyphase) stride-2 transposed 3D convolution, NCDHW.

Counterpart of ``vaegam_tpu/ops/convt.py``.  Each output parity class
(cd, ch, cw) in {0,1}^3 of a stride-2 transposed conv is a dense stride-1
conv of the raw input with the decimated kernel ``K[r_d::2, r_h::2,
r_w::2]``; the 8 class outputs interleave into the result.  The JAX
package measured both forms slower than XLA's dilated lowering on the TPU
and wires neither into its decoder; neither does this package: they are
library functions, held to ``F.conv_transpose3d``.

Weights are in ``nn.ConvTranspose3d``'s layout (I, O, kD, kH, kW).  The
polyphase derivation works on the kernel of the equivalent dilated
correlation, which is that weight flipped on its three spatial axes with
I and O swapped (the JAX package's DHWIO kernel).  Per axis, stride 2,
dilated-conv padding lo = k-1-p and hi = k-1-p+op, with r_c = (lo - c)
mod 2 and n0_c = (c + r_c - lo)/2:
  O[c + 2m] = sum_j K[r_c + 2j] * X[n0_c + m + j],
a stride-1 correlation with K[r_c::2] shifted by n0_c, written as a
(possibly negative, possibly asymmetric) padding applied with ``F.pad``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _axis_class(i: int, k: int, lo: int, hi: int, c: int) -> Tuple[int, int, int, int]:
    """Per-axis polyphase parameters of output parity class c:
    (r, pad_lo, pad_hi, out_len) of its stride-1 sub-conv."""
    l_out = 2 * i + lo + hi - k
    r = (lo - c) % 2
    n0 = (c + r - lo) // 2
    k_c = (k - r + 1) // 2
    out_c = (l_out - 1 - c) // 2 + 1 if l_out > c else 0
    # sub-conv input index range: n0 .. n0 + out_c - 1 + k_c - 1
    return r, -n0, (n0 + out_c + k_c - 2) - (i - 1), out_c


def _conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(I, O, k...) transposed-conv weight -> (O, I, k...) kernel of the
    equivalent dilated correlation."""
    return w.flip(2, 3, 4).transpose(0, 1)


def _pad_conv(x, w, padding):
    """Stride-1 VALID conv after a per-axis (lo, hi) padding, negative
    entries cropping."""
    (ld, hd), (lh, hh), (lw, hw) = padding
    return F.conv3d(F.pad(x, (lw, hw, lh, hh, ld, hd)), w)


def _geometry(w, pad, outpad, dims):
    ksize = w.shape[2:]
    lo = [k - 1 - p for k, p in zip(ksize, pad)]
    hi = [k - 1 - p + op for k, p, op in zip(ksize, pad, outpad)]
    l_out = [2 * i + a + b - k for i, k, a, b in zip(dims, ksize, lo, hi)]
    return ksize, lo, hi, l_out


def conv_transpose_2x_fused(
    x: torch.Tensor,           # (B, I, D, H, W)
    w: torch.Tensor,           # (I, O, kD, kH, kW)
    pad: Sequence[int],
    outpad: Sequence[int],
) -> torch.Tensor:
    """Stride-2 transposed conv as ONE dense stride-1 conv with 8x the output
    channels (the decimated kernels zero-aligned to a common tap window),
    then a depth-to-space interleave.  No bias."""
    dims = x.shape[2:]
    ksize, lo, _, l_out = _geometry(w, pad, outpad, dims)
    wc = _conv_kernel(w)
    co = wc.shape[0]

    ax = []  # per axis: the classes' (r, n0, k_c), jj_min, packed taps, M
    for a in range(3):
        classes = []
        for c in range(2):
            r = (lo[a] - c) % 2
            classes.append((r, (c + r - lo[a]) // 2, (ksize[a] - r + 1) // 2))
        jj_min = min(n0 for _, n0, _ in classes)
        jj_max = max(n0 + k_c - 1 for _, n0, k_c in classes)
        ax.append((classes, jj_min, jj_max - jj_min + 1, (l_out[a] + 1) // 2))

    # the packed kernel: class (cd, ch, cw) at output channels
    # ((cd*2 + ch)*2 + cw)*O .. +O, its decimated kernel at its tap offset
    blocks = []
    for cd in range(2):
        for ch in range(2):
            for cw in range(2):
                (rd, n0d, kcd), (rh, n0h, kch), (rw, n0w, kcw) = (
                    ax[0][0][cd], ax[1][0][ch], ax[2][0][cw])
                sub = wc[:, :, rd::2, rh::2, rw::2]
                od, oh, ow = n0d - ax[0][1], n0h - ax[1][1], n0w - ax[2][1]
                blocks.append(F.pad(sub, (ow, ax[2][2] - ow - kcw,
                                          oh, ax[1][2] - oh - kch,
                                          od, ax[0][2] - od - kcd)))
    w_packed = torch.cat(blocks)                       # (8*O, I, kp...)

    padding = tuple((-a[1], (a[1] + a[2] + a[3] - 2) - (i - 1))
                    for a, i in zip(ax, dims))
    y = _pad_conv(x, w_packed, padding)                # (B, 8*O, Md, Mh, Mw)
    b = x.shape[0]
    md, mh, mw = ax[0][3], ax[1][3], ax[2][3]
    y = y.reshape(b, 2, 2, 2, co, md, mh, mw).permute(0, 4, 5, 1, 6, 2, 7, 3)
    y = y.reshape(b, co, 2 * md, 2 * mh, 2 * mw)
    return y[:, :, : l_out[0], : l_out[1], : l_out[2]]


def conv_transpose_2x(
    x: torch.Tensor,           # (B, I, D, H, W)
    w: torch.Tensor,           # (I, O, kD, kH, kW)
    pad: Sequence[int],        # torch's padding per spatial dim
    outpad: Sequence[int],     # torch's output_padding per spatial dim
) -> torch.Tensor:
    """Stride-2 transposed conv, polyphase-decomposed into 8 class convs and
    strided writes.  No bias."""
    dims = x.shape[2:]
    ksize, lo, hi, l_out = _geometry(w, pad, outpad, dims)
    wc = _conv_kernel(w)
    out = x.new_zeros((x.shape[0], wc.shape[0], *l_out))
    for cd in range(2):
        rd, plo_d, phi_d, od = _axis_class(dims[0], ksize[0], lo[0], hi[0], cd)
        if od <= 0:
            continue
        for ch in range(2):
            rh, plo_h, phi_h, oh = _axis_class(dims[1], ksize[1], lo[1], hi[1], ch)
            if oh <= 0:
                continue
            for cw in range(2):
                rw, plo_w, phi_w, ow = _axis_class(dims[2], ksize[2], lo[2], hi[2], cw)
                if ow <= 0:
                    continue
                y = _pad_conv(x, wc[:, :, rd::2, rh::2, rw::2],
                              ((plo_d, phi_d), (plo_h, phi_h), (plo_w, phi_w)))
                out[:, :, cd::2, ch::2, cw::2] = y
    return out
