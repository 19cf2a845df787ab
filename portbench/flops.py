"""The yardstick's arithmetic: a step's products, conv5's bound, the peaks.

Operations are counted from the configuration's shapes, never from the
program.  A product counts 2 FLOPs a multiply-add.  For every conv, FC and
einsum of the train step it counts the forward, the input gradient and the
weight gradient (each with the forward's multiply-adds); an operand that
is a constant or a draw (the GLM maps, the noise) has no gradient.
Convolutions count the multiply-adds that touch real data: no tap that
falls on zero padding, and, for transposed convs, none of the zeros that
dilation inserts.  Left out: elementwise work (norms, activations, the
ELBO's sums, the GLM distance's sum of squares), the Cholesky
factorizations, the LU and triangular solves, and Adam.

Peaks (NVIDIA H100 SXM data sheet, dense): 495e12 FLOP/s for TF32 on the
tensor cores, the highest rate at which the card multiplies float32
operands, so no implementation of the float32 step can exceed it; HBM
3.35e12 bytes/s.  Both assume the card's full 700 W.
"""

from __future__ import annotations

import math

from .reference import conv5_input_shape, decoder_seed_shape

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def _axis_pairs(n_in: int, k: int, s: int, p: int, n_out: int, transposed: bool) -> int:
    """(input, tap) pairs along one axis whose output lands inside the
    output: for a conv o = (i + p - j) / s, for a transposed conv
    o = i * s - p + j."""
    count = 0
    for i in range(n_in):
        for j in range(k):
            if transposed:
                o = i * s - p + j
                count += 0 <= o < n_out
            else:
                q = i + p - j
                count += q >= 0 and q % s == 0 and q // s < n_out
    return count


def _conv_out(n_in, k, s, p, op=0, transposed=False):
    if transposed:
        return (n_in - 1) * s - 2 * p + k + op
    return (n_in + 2 * p - k) // s + 1


def conv_macs(rows, ci, co, spatial, kernel, stride=(1, 1, 1), pad=(0, 0, 0),
              out_pad=(0, 0, 0), transposed=False):
    """(multiply-adds, output spatial shape) of one conv over `rows` inputs."""
    pairs, out = 1, []
    for n, k, s, p, op in zip(spatial, kernel, stride, pad, out_pad):
        o = _conv_out(n, k, s, p, op, transposed)
        pairs *= _axis_pairs(n, k, s, p, o, transposed)
        out.append(o)
    return rows * ci * co * pairs, tuple(out)


def step_products(cfg: dict, batch: int) -> list:
    """[(name, forward multiply-adds, passes)] of one train step at `batch`:
    passes is 3 (forward, input and weight gradients) or 2 (one operand is
    a constant or a draw)."""
    nf, c, L = cfg["nf"], 2 * cfg["nf"], cfg["num_latents"]
    n_cov, p = cfg["num_covariates"], cfg["num_inducing_pts"]
    rows_d = (n_cov + 1) * batch
    img = tuple(cfg["img_shape"])
    out = []

    sp = img
    for name, ci, co, s in (("conv1", 1, nf, 1), ("conv2", nf, nf, 2), ("conv3", nf, c, 1),
                            ("conv4", c, c, 2), ("conv5", c, c, 1)):
        macs, sp = conv_macs(batch, ci, co, sp, (3, 3, 3), (s,) * 3)
        out.append((f"enc/{name}", macs, 3))
    flat = c * math.prod(sp)
    for name, i, o in (("fc1", flat, 200), ("fc2", 200, 100)):
        out.append((f"enc/{name}", batch * i * o, 3))
    for k in "123":
        out.append((f"enc/fc3{k}", batch * 100 * 50, 3))
        out.append((f"enc/fc4{k}", batch * 50 * L, 3))

    seed, _ = decoder_seed_shape(img)
    z_dim = L + n_cov + 1
    for name, i, o in (("fc5", z_dim, 50), ("fc6", 50, 100), ("fc7", 100, 200),
                       ("fc8", 200, c * math.prod(seed))):
        out.append((f"dec/{name}", rows_d * i * o, 3))
    sp = seed
    for name, ci, co, k, s, pd, op in (
            ("convt1", c, c, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0)),
            ("convt2", c, c, (3, 3, 3), 2, (1, 0, 1), (1, 0, 1)),
            ("convt3", c, nf, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0)),
            ("convt4", nf, nf, (5, 3, 3), 2, (0, 0, 0), (0, 0, 0)),
            ("convt5", nf, 1, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0))):
        macs, sp = conv_macs(rows_d, ci, co, sp, k, (s,) * 3, pd, op, transposed=True)
        out.append((f"dec/{name}", macs, 3))

    img_dim = math.prod(img)
    g = 6
    out += [
        # GP bank: A qu_m, A (qu_S - Kuu), (.) A^T
        ("gp/a_qu_m", g * batch * p, 3),
        ("gp/a_m", g * batch * p * p, 3),
        ("gp/a_m_at", g * batch * p * batch, 3),
        # the gain sample L eps (eps is a draw), the HRF convolution of the
        # task's gains (the taps are constants)
        ("gain/l_eps", n_cov * batch * batch, 2),
        ("gain/hrf", max(0, n_cov - 7) * batch * 15, 2),
        # composition sum_c gains[c, b] diffs[c, b, :]
        ("compose", n_cov * batch * img_dim, 3),
    ]
    if cfg["glm_reg_scale"]:
        # the GLM distance's cross term diffs . glm (the maps are constants)
        out.append(("glm/dot", n_cov * batch * img_dim, 2))
    return out


def step_flops(cfg: dict, batch: int) -> float:
    """FLOPs of one train step's products at `batch`."""
    return float(sum(2 * macs * passes for _, macs, passes in step_products(cfg, batch)))


def conv5_shape(cfg: dict, batch: int) -> tuple:
    """conv5's input (B, Ci, D, H, W)."""
    return (batch, 2 * cfg["nf"], *conv5_input_shape(cfg["img_shape"]))


def conv5_bound_s(shape) -> float:
    """The least time of one conv5 call: its multiply-adds at the TF32 peak
    against its bytes (input, weight, bias and output, each once) at the
    HBM peak, whichever is longer."""
    b, ci, d, h, w = shape
    co = ci
    n_out = b * co * (d - 2) * (h - 2) * (w - 2)
    ops_s = 2.0 * n_out * 27 * ci / PEAK_FLOPS
    bytes_s = 4.0 * (b * ci * d * h * w + co * ci * 27 + co + n_out) / PEAK_BYTES
    return max(ops_s, bytes_s)
