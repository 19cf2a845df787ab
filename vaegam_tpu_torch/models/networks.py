"""Encoder / decoder networks on parameter dicts, NCDHW layout.

Counterpart of ``vaegam_tpu.models.networks`` (same architecture, same
shapes).  Weights use the ``nn.Conv3d`` / ``nn.ConvTranspose3d`` /
``nn.Linear`` layouts: conv (O, I, kD, kH, kW), transposed conv
(I, O, kD, kH, kW), linear (out, in).  Features flatten channel-major, as
torch does; ``utils.jax_params`` owns the permutations and flips that carry
JAX weights (channel-minor flatten, flipped DHWIO transposed-conv kernels)
into this layout.

The transposed convs are torch's own: convt2 is
``conv_transpose3d(stride=2, padding=(1,0,1), output_padding=(1,0,1))`` and
convt4 has a (5,3,3) kernel at stride 2, which is what the JAX
``lhs_dilation`` convs with padding (k-1-p, k-1-p+op) compute.

Precision follows the JAX recipe step for step: with a half-precision
``conv_dtype`` the stack input is cast once, activations stay in it between
layers, weights are cast per call, the fp32 bias add promotes and casts
back, norm statistics are fp32, and the FC layers, heads and sigmoid run in
fp32.  A float64 model (``VAEGAMConfig.dtype``) is JAX's partial float64:
everything in float64 but the norm statistics and the sigmoid, which the
JAX code casts to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import products
from ..ops.conv5 import conv5
from ..ops.convt5 import convt5
from ..ops.packed_conv import packed_conv3d
from ..parallel.mesh import all_reduce_sum
from ..utils import prng

_BN_EPS = 1e-5

REFERENCE_IMG_SHAPE = (41, 49, 35)


def encoder_out_shape(img_shape) -> tuple:
    """Spatial shape after the 5-conv encoder chain (k3: s1,s2,s1,s2,s1)."""
    out = []
    for i in img_shape:
        a = i - 2
        a = (a - 3) // 2 + 1
        a = a - 2
        a = (a - 3) // 2 + 1
        a = a - 2
        if a < 1:
            raise ValueError(f"img_shape axis {i} too small for the conv chain")
        out.append(a)
    return tuple(out)


def decoder_seed_shape(img_shape) -> tuple:
    """(seed_shape, crop) for the 5-convt decoder chain.

    Per-axis output of the chain: D,H -> 4s+17, W -> 4s+15.  The seed is the
    smallest s reaching the target; any surplus is cropped from the tail.
    (41,49,35) gives the reference's (6,8,5) seed with zero crop.
    """
    offsets = (17, 17, 15)
    seed, crop = [], []
    for i, c in zip(img_shape, offsets):
        s = -(-(i - c) // 4)  # ceil
        if s < 1:
            raise ValueError(f"img_shape axis {i} too small for the decoder chain")
        seed.append(s)
        crop.append(4 * s + c - i)
    return tuple(seed), tuple(crop)


# ---------------------------------------------------------------------------
# init: torch-default uniform bounds U(+-1/sqrt(fan_in)) for weight and bias,
# drawn with JAX's PRNG in the JAX package's layout and key order
# (vaegam_tpu/models/networks.py); utils.jax_params.params_from_jax maps
# the trees to the port's layout
# ---------------------------------------------------------------------------

def _conv_init(key, kshape, fan_in, dtype):
    """kshape: (D, H, W, I, O), the JAX layout."""
    k_w, k_b = prng.split(key)
    bound = 1.0 / np.sqrt(fan_in)
    return {"w": prng.uniform(k_w, kshape, -bound, bound, dtype),
            "b": prng.uniform(k_b, (kshape[-1],), -bound, bound, dtype)}


def _linear_init(key, in_f, out_f, dtype):
    k_w, k_b = prng.split(key)
    bound = 1.0 / np.sqrt(in_f)
    return {"w": prng.uniform(k_w, (in_f, out_f), -bound, bound, dtype),
            "b": prng.uniform(k_b, (out_f,), -bound, bound, dtype)}


def _bn_init(ch, dtype):
    return {"scale": np.ones(ch, dtype), "shift": np.zeros(ch, dtype)}


def init_encoder(key, nf, num_latents, img_shape, dtype=np.float32):
    """The encoder's parameters (numpy in `dtype`, JAX layout) from a JAX
    PRNG key."""
    ks = prng.split(key, 13)
    eo = encoder_out_shape(img_shape)
    flat = 2 * nf * eo[0] * eo[1] * eo[2]
    c = 2 * nf
    return {
        "conv1": _conv_init(ks[0], (3, 3, 3, 1, nf), 27, dtype),
        "conv2": _conv_init(ks[1], (3, 3, 3, nf, nf), nf * 27, dtype),
        "conv3": _conv_init(ks[2], (3, 3, 3, nf, c), nf * 27, dtype),
        "conv4": _conv_init(ks[3], (3, 3, 3, c, c), c * 27, dtype),
        "conv5": _conv_init(ks[4], (3, 3, 3, c, c), c * 27, dtype),
        "bn1": _bn_init(1, dtype),
        "bn3": _bn_init(nf, dtype),
        "bn5": _bn_init(c, dtype),
        "fc1": _linear_init(ks[5], flat, 200, dtype),
        "fc2": _linear_init(ks[6], 200, 100, dtype),
        "fc31": _linear_init(ks[7], 100, 50, dtype),
        "fc32": _linear_init(ks[8], 100, 50, dtype),
        "fc33": _linear_init(ks[9], 100, 50, dtype),
        "fc41": _linear_init(ks[10], 50, num_latents, dtype),
        "fc42": _linear_init(ks[11], 50, num_latents, dtype),
        "fc43": _linear_init(ks[12], 50, num_latents, dtype),
    }


def init_decoder(key, nf, z_dim, img_shape, dtype=np.float32):
    """The decoder's parameters (numpy in `dtype`, JAX layout) from a JAX
    PRNG key."""
    ks = prng.split(key, 9)
    seed, _ = decoder_seed_shape(img_shape)
    c = 2 * nf
    seed_flat = c * seed[0] * seed[1] * seed[2]
    # ConvTranspose3d fan_in in torch is out_ch * prod(kernel)
    return {
        "fc5": _linear_init(ks[0], z_dim, 50, dtype),
        "fc6": _linear_init(ks[1], 50, 100, dtype),
        "fc7": _linear_init(ks[2], 100, 200, dtype),
        "fc8": _linear_init(ks[3], 200, seed_flat, dtype),
        "convt1": _conv_init(ks[4], (3, 3, 3, c, c), c * 27, dtype),
        "convt2": _conv_init(ks[5], (3, 3, 3, c, c), c * 27, dtype),
        "convt3": _conv_init(ks[6], (3, 3, 3, c, nf), nf * 27, dtype),
        "convt4": _conv_init(ks[7], (5, 3, 3, nf, nf), nf * 45, dtype),
        "convt5": _conv_init(ks[8], (3, 3, 3, nf, 1), 27, dtype),
        "bnt1": _bn_init(c, dtype),
        "bnt3": _bn_init(c, dtype),
        "bnt5": _bn_init(nf, dtype),
    }


# ---------------------------------------------------------------------------
# layer applies
# ---------------------------------------------------------------------------

def batch_stat_norm(x, p, groups: int = 1, stat_dtype=None, mesh=None,
                    global_rows=None):
    """Normalize with the CURRENT batch statistics over (N, D, H, W).

    BatchNorm3d(track_running_stats=False) semantics: biased variance,
    eps 1e-5.  groups > 1 computes the statistics per contiguous group of
    N/groups rows (the fused 9B decode's per-one-hot statistics).
    Statistics are taken in ``stat_dtype``, by default in at least fp32;
    a float64 model passes float32, as the JAX code casts to it; the
    normalized values then meet the float64 scale and shift.

    Under a data-parallel ``mesh`` x holds this rank's rows of a batch of
    ``global_rows`` rows (each group's rows its share of that group's), and
    the statistics are the global batch's: the sum, then the centred sum of
    squares (the same two passes), each summed over the ranks.
    """
    n, c = x.shape[:2]
    xg = x.reshape(groups, n // groups, *x.shape[1:])
    xg = xg.to(stat_dtype or torch.promote_types(x.dtype, torch.float32))
    axes = (1, 3, 4, 5)
    if mesh is None:
        mean = xg.mean(dim=axes, keepdim=True)
        var = (xg - mean).square().mean(dim=axes, keepdim=True)
    else:
        count = (global_rows // groups) * math.prod(x.shape[2:])
        mean = all_reduce_sum(xg.sum(dim=axes, keepdim=True), mesh) / count
        var = all_reduce_sum((xg - mean).square().sum(dim=axes, keepdim=True),
                             mesh) / count
    xn = (xg - mean) * torch.rsqrt(var + _BN_EPS)
    shape = (1, 1, c, 1, 1, 1)
    out = xn * p["scale"].reshape(shape) + p["shift"].reshape(shape)
    return out.to(x.dtype).reshape(x.shape)


def _linear(x, p, op=products.TORCH):
    return op.linear(x, p["w"], p["b"])


def _conv(x, p, stride, conv_dtype=None, pack=None, pack_padding=((0, 0),) * 3,
          op=products.TORCH):
    """conv_dtype None: fp32 with the bias fused.  Otherwise x is already in
    conv_dtype (cast once at stack entry, so activations stay in it between
    layers); the weight is cast per call, the fp32 bias add promotes and the
    result returns to x's dtype, as the JAX recipe's ``(y + b).astype``.

    pack=(s_h, s_w) lane-packs a stride-1 conv (``ops.packed_conv``, the
    same math) after padding by ``pack_padding``; the weight is cast first
    and packed after, as in JAX.  op is the set of operations
    (``products.ops``: torch's, or the TPU's arithmetic)."""
    w = p["w"] if conv_dtype is None else p["w"].to(conv_dtype)
    bias = p["b"] if conv_dtype is None else None
    if pack is not None and stride == 1:
        y = packed_conv3d(x, w, pack_padding, pack, bias=bias, op=op)
    else:
        y = op.conv3d(x, w, bias, stride=stride)
    return y if conv_dtype is None else (y + p["b"].reshape(-1, 1, 1, 1)).to(x.dtype)


def _conv_t(x, p, stride=1, padding=0, output_padding=0, conv_dtype=None, pack=None,
            op=products.TORCH):
    """Transposed conv with the precision rule of :func:`_conv`.

    pack=(s_h, s_w) lane-packs a stride-1 layer as the conv it equals: the
    (I, O, k...) weight flipped on its three spatial axes with I and O
    swapped (the JAX package's unflipped DHWIO kernel, utils/jax_params.py),
    padded by k-1-padding."""
    if pack is not None and stride == 1:
        w = p["w"].flip(2, 3, 4).transpose(0, 1)
        pads = tuple((k - 1 - padding,) * 2 for k in w.shape[2:])
        return _conv(x, {"w": w, "b": p["b"]}, 1, conv_dtype, pack, pads, op)
    kw = dict(stride=stride, padding=padding, output_padding=output_padding)
    if conv_dtype is None:
        return op.conv_transpose3d(x, p["w"], p["b"], **kw)
    y = op.conv_transpose3d(x, p["w"].to(conv_dtype), None, **kw)
    return (y + p["b"].reshape(-1, 1, 1, 1)).to(x.dtype)


def encode(params, x, conv5_kernel: bool = True, conv_dtype=None,
           stat_dtype=None, mesh=None, global_rows=None, conv_pack=None,
           tpu_products: bool = False):
    """x: (B, D, H, W) -> (mu, u, d), each (B, num_latents).

    conv_dtype (e.g. torch.bfloat16) selects the conv stack's precision;
    norm statistics, the FC stack and the heads stay fp32.  stat_dtype is
    the norm statistics' dtype (see :func:`batch_stat_norm`, which also
    says what ``mesh`` and ``global_rows`` do: x is then this rank's rows
    of a global batch of that many).  conv5_kernel
    routes the fp32 conv5 through ``ops.conv5`` (the hand-written CUDA
    kernel on CUDA tensors, its plain version on CPU tensors) instead of
    ``F.conv3d``; a half-precision conv5 takes the stock conv, as the JAX
    package's Pallas conv5 is fp32-only.  conv_pack=(s_h, s_w) lane-packs
    the stride-1 convs (conv1, conv3, and conv5 where it does not take the
    kernel, which keeps precedence as JAX's ``pallas_conv5`` does).
    tpu_products computes every conv and FC product in the TPU's arithmetic
    (``ops.products``; conv5's kernel takes its one-pass bfloat16 path).
    """
    cd, cp, op = conv_dtype, conv_pack, products.ops(tpu_products)
    h = x[:, None]  # NCDHW with C=1
    if cd is not None:
        h = h.to(cd)  # one downcast; activations stay cd across the stack
    def norm(h, p):
        return batch_stat_norm(h, p, 1, stat_dtype, mesh, global_rows)

    h = op.relu(_conv(norm(h, params["bn1"]), params["conv1"], 1, cd, cp, op=op))
    h = op.relu(_conv(h, params["conv2"], 2, cd, op=op))
    h = op.relu(_conv(norm(h, params["bn3"]), params["conv3"], 1, cd, cp, op=op))
    h = op.relu(_conv(h, params["conv4"], 2, cd, op=op))
    h5 = norm(h, params["bn5"])
    if conv5_kernel and cd is None:
        h = op.relu(conv5(h5, params["conv5"]["w"], params["conv5"]["b"],
                          one_pass=tpu_products))
    else:
        h = op.relu(_conv(h5, params["conv5"], 1, cd, cp, op=op))
    h = h.reshape(h.shape[0], -1).to(x.dtype)  # channel-major; FC stack in fp32

    def fc(h, name):
        return _linear(h, params[name], op)

    h = op.relu(fc(h, "fc1"))
    h = op.relu(fc(h, "fc2"))
    mu = fc(op.relu(fc(h, "fc31")), "fc41")
    u = fc(op.relu(fc(h, "fc32")), "fc42")
    d = torch.exp(fc(op.relu(fc(h, "fc33")), "fc43"))
    return mu, u, d


def decode(params, z, img_shape=REFERENCE_IMG_SHAPE, stat_groups: int = 1,
           conv_dtype=None, fp32_final: bool = False, stat_dtype=None,
           mesh=None, global_rows=None, conv_pack=None, tpu_products: bool = False):
    """z: (B*, z_dim) -> sigmoid volume flattened to (B*, prod(img_shape)).

    stat_groups: contiguous batch groups for the batch-stat norms.
    conv_dtype: the conv stack's precision (FC layers stay fp32).
    fp32_final: run convt5, the conv feeding the sigmoid, in fp32 even when
    conv_dtype is half precision.  stat_dtype: the norm statistics' dtype,
    and the sigmoid's (its output's) when given; by default the sigmoid
    runs in z's dtype.  Under a data-parallel ``mesh`` z holds this rank's
    rows of each group and ``global_rows`` counts the global decode's rows
    (see :func:`batch_stat_norm`).  An fp32 convt5 (an fp32 stack, or
    fp32_final) runs through ``ops.convt5`` (the hand-written CUDA kernels on
    CUDA tensors, their plain version on CPU tensors); a float64 or half
    precision one, and every one under tpu_products, takes the stock op.
    conv_pack=(s_h, s_w) lane-packs the stride-1 layers convt1, convt3 and
    convt5 where it takes the stock op (the kernel keeps precedence).
    tpu_products: every product in the TPU's arithmetic (``ops.products``).
    """
    cd, sd, cp, op = conv_dtype, stat_dtype, conv_pack, products.ops(tpu_products)

    def norm(h, p):
        return batch_stat_norm(h, p, stat_groups, sd, mesh, global_rows)

    seed, crop = decoder_seed_shape(img_shape)
    c = params["convt1"]["w"].shape[0]
    h = op.relu(_linear(z, params["fc5"], op))
    h = op.relu(_linear(h, params["fc6"], op))
    h = op.relu(_linear(h, params["fc7"], op))
    h = op.relu(_linear(h, params["fc8"], op))
    h = h.reshape(-1, c, *seed)
    if cd is not None:
        h = h.to(cd)  # one downcast; activations stay cd across the stack
    h = op.relu(_conv_t(norm(h, params["bnt1"]), params["convt1"], conv_dtype=cd, pack=cp,
                        op=op))
    h = op.relu(_conv_t(h, params["convt2"], 2, (1, 0, 1), (1, 0, 1), conv_dtype=cd, op=op))
    h = op.relu(_conv_t(norm(h, params["bnt3"]), params["convt3"], conv_dtype=cd, pack=cp,
                        op=op))
    h = op.relu(_conv_t(h, params["convt4"], 2, conv_dtype=cd, op=op))
    h = norm(h, params["bnt5"])
    if fp32_final and cd is not None:
        h, cd = h.to(z.dtype), None
    if cd is None and h.dtype == torch.float32 and not tpu_products:
        h = convt5(h, params["convt5"]["w"], params["convt5"]["b"])
    else:
        h = _conv_t(h, params["convt5"], conv_dtype=cd, pack=cp, op=op)
    if any(crop):
        h = h[:, :, : h.shape[2] - crop[0], : h.shape[3] - crop[1],
              : h.shape[4] - crop[2]]
    h = torch.sigmoid(h.to(sd or z.dtype))  # the log-likelihood consumes fp32 maps
    return h.reshape(h.shape[0], -1)
