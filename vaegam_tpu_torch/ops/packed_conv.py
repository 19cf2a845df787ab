"""Lane-packed stride-1 3D convolution (overlapped-window channel packing), NCDHW.

Counterpart of ``vaegam_tpu/ops/packed_conv.py``.  ``s_h x s_w`` consecutive
output positions fold into the conv's output channels (O' = s_h*s_w*O) and
the overlapped input windows they share fold into its input channels
(K' = (s_h+kh-1)*(s_w+kw-1)*I); what is left is a (kd, 1, 1) conv over
the (D, H/s_h, W/s_w) block grid.  The math is the plain conv's; the dense
embedding multiplies its FLOPs by :func:`flop_inflation`.  ``conv_pack``
is off by default: on the TPU the packed step ran at 0.31-0.48x of the
plain one, and this package keeps it as the measured arm it is.

Derived for the NCDHW layout, with no transpose to channels-last:
  * the input blocks ``out[b, j] = x[b*s + j]`` are ``Tensor.unfold(dim,
    s+k-1, s)`` of the input padded to ``nb*s + k - 1`` (its backward is
    torch's ``unfold_backward``);
  * the packed weight is the weight zero-padded by s-1 on each side of H
    and W, unfolded with step 1 and flipped along the window index: two
    launches (the pad and the flip's copy), no arithmetic, exact in every
    dtype;
  * ``F.conv3d`` pads symmetrically, so an asymmetric D padding is
    materialised with ``F.pad`` together with the H and W padding.

Channel order inside the packed contraction: input (ci, jh, jw), output
(o, sh, sw).  The packed weight is not a parameter, so checkpoints and
``params_from_jax`` are unchanged by a pack.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import products


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_pack(kh: int, kw: int, pack: Tuple[int, int]) -> None:
    """Raise ValueError unless ``pack`` suits an H x W kernel of kh x kw."""
    s_h, s_w = pack
    if s_h < 1 or s_w < 1 or kh - 1 > s_h or kw - 1 > s_w:
        raise ValueError(
            f"pack {tuple(pack)} for a {kh}x{kw} (H x W) kernel: the pack factor "
            "must be >= kernel-1 per axis (the JAX package's block spill rule)")


def pack_weights(w: torch.Tensor, s_h: int, s_w: int) -> torch.Tensor:
    """(O, I, kd, kh, kw) -> (O*s_h*s_w, I*(s_h+kh-1)*(s_w+kw-1), kd, 1, 1).

    ``w_packed[(o, sh, sw), (ci, jh, jw), d] = w[o, ci, d, jh-sh, jw-sw]`` on
    the band and 0 elsewhere.
    """
    o, i, kd, kh, kw = w.shape
    wh, ww = s_h + kh - 1, s_w + kw - 1
    wp = F.pad(w, (s_w - 1, s_w - 1, s_h - 1, s_h - 1))
    # window a of the step-1 unfold starts at a = s_h-1-sh: flip it to sh
    u = wp.unfold(3, wh, 1).unfold(4, ww, 1)       # (O, I, kd, s_h, s_w, wh, ww)
    u = u.permute(0, 3, 4, 1, 5, 6, 2).flip(1, 2)  # (O, sh, sw, I, jh, jw, kd)
    return u.reshape(o * s_h * s_w, i * wh * ww, kd, 1, 1)


def packed_conv3d(
    x: torch.Tensor,                 # (B, I, D, H, W)
    w: torch.Tensor,                 # (O, I, kd, kh, kw)
    padding: Sequence[Tuple[int, int]] = ((0, 0), (0, 0), (0, 0)),
    pack: Tuple[int, int] = (4, 4),
    bias: torch.Tensor | None = None,
    op=products.TORCH,
) -> torch.Tensor:
    """Stride-1 3D conv, ``F.conv3d(x, w, bias)`` after padding each spatial
    axis by ``padding`` (lo, hi), with H and W lane-packed by ``pack``;
    ``bias`` (O,) is added inside the packed conv.  ``op`` (``products.ops``)
    gives the conv: torch's, or the TPU's arithmetic, where the packing only
    moves values and inserts zeros, so rounding the packed operands rounds
    the layer's own.
    """
    s_h, s_w = pack
    _, _, kd, kh, kw = w.shape
    check_pack(kh, kw, pack)
    (lo_d, hi_d), (lo_h, hi_h), (lo_w, hi_w) = padding
    h_out = x.shape[3] + lo_h + hi_h - kh + 1
    w_out = x.shape[4] + lo_w + hi_w - kw + 1
    nb_h, nb_w = _cdiv(h_out, s_h), _cdiv(w_out, s_w)
    # H and W padded to nb*s + k - 1 (the conv padding, then the last block's
    # tail); D's padding stays the conv's where it is symmetric
    d_pad = (0, 0) if lo_d == hi_d else (lo_d, hi_d)
    xp = F.pad(x, (lo_w, hi_w + nb_w * s_w - w_out,
                   lo_h, hi_h + nb_h * s_h - h_out, *d_pad))
    wh, ww = s_h + kh - 1, s_w + kw - 1
    xb = xp.unfold(3, wh, s_h).unfold(4, ww, s_w)   # (B, I, D', nbh, nbw, wh, ww)
    b, i, dp = xb.shape[:3]
    xb = xb.permute(0, 1, 5, 6, 2, 3, 4).reshape(b, i * wh * ww, dp, nb_h, nb_w)

    w_packed = pack_weights(w, s_h, s_w)
    if bias is not None:
        bias = bias[:, None].expand(-1, s_h * s_w).reshape(-1)  # (o, sh, sw)
    y = op.conv3d(xb, w_packed, bias, padding=(lo_d if lo_d == hi_d else 0, 0, 0))
    o, d_out = w.shape[0], y.shape[2]
    y = y.reshape(b, o, s_h, s_w, d_out, nb_h, nb_w).permute(0, 1, 4, 5, 2, 6, 3)
    y = y.reshape(b, o, d_out, nb_h * s_h, nb_w * s_w)
    return y[:, :, :, :h_out, :w_out]


def flop_inflation(kh: int, kw: int, pack: Tuple[int, int]) -> float:
    """Dense-FLOP multiplier of the packed embedding against the plain conv."""
    s_h, s_w = pack
    return ((s_h + kh - 1) / kh) * ((s_w + kw - 1) / kw)
