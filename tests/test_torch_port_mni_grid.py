"""The port's train step at the MNI152 2 mm grid's rounding, held to the
benchmark's plain reference (``portbench/reference.py``) in float64.

The benchmark's ``vaegam-mni91-fp32`` runs 91x109x91 at P = 6.  Its widths
are too large for a CPU test, so the step runs thin (nf 2, 8 latents,
batch 2) on the smallest grid that rounds as 91x109x91 does on every axis:
the same remainders dropped by conv2 and conv4 (stride 2), the same
decoder seed crop, (2, 0, 0).  The study is the cell's own traffic, one
subject of 98 volumes, so the inducing grids span the cell's motion
ranges.  The condition of Kuu over those ranges is what sets the cell's
P = 6.
"""

import math
import statistics

import mpmath
import pytest
import torch

from portbench import harness, reference, study
from torch_port_common import MNI_ROUNDING as GRID

MNI = (91, 109, 91)
# the GP kernel's scale and lengthscale: kvar cancels from Kuq Kuu^-1, so
# their gradients are differences of large terms through Kuq and Kuu whose
# float64 rounding cond(Kuu) (~1e6 at P = 6) amplifies: 32 seeds read
# <= 1.9e-9 of the larger of the leaf's norm and the median leaf's
KERNEL_LEAVES = ("gp/log_ls", "gp/logkvar")
KERNEL_TOL = 1e-7
# every other leaf: the same float64 operations in other orders, <= 2.2e-13
# of the leaf's norm over 32 seeds; a float32 rounding anywhere reads >= 1e-8
LEAF_TOL = 1e-11
# the loss: 32 seeds read equal; float64 sums over ~1e5 terms in another
# order would part by ~1e-14
LOSS_TOL = 1e-13


# seeds whose studies span the inducing ranges the cell draws: 132 motion
# ranges, 3.77 to 6.95 wide
COND_SEEDS = list(range(20)) + [2**31 + 16, 5123456789]


def _kuu_cond(p, width, ls):
    """cond(Kuu) of P inducing points evenly over `width` at lengthscale
    `ls`, in 60-digit arithmetic (float64 cannot read it past ~1e16).  Kuu
    depends on width / ls alone, and its condition grows as that shrinks."""
    with mpmath.workdps(60):
        h, ls = mpmath.mpf(width) / (p - 1), mpmath.mpf(ls)
        kuu = mpmath.matrix([[mpmath.exp(-((i - j) * h) ** 2 / (2 * ls ** 2))
                              for j in range(p)] for i in range(p)])
        eig = mpmath.eigsy(kuu)[0]
        return float(max(eig) / min(eig))


def kuu_conds(p):
    """The least and the largest cond(Kuu) over the cell's drawn motion
    ranges and the lengthscales the model reaches: max_ls * sigmoid(
    exp(log_ls) + 0.5) lies between 3 * sigmoid(0.5) and max_ls = 3."""
    _, cfg, traffic = harness.load_cell("mni91-train-eager")
    widths = [hi - lo for seed in COND_SEEDS
              for lo, hi in study.make_study(traffic, (1, 1, 1), cfg["num_covariates"],
                                             seed)["xu_ranges"]]
    ls_min = cfg["max_ls"] / (1 + math.exp(-0.5))
    return _kuu_cond(p, max(widths), ls_min), _kuu_cond(p, min(widths), cfg["max_ls"])


def test_kuu_condition_sets_the_inducing_points():
    """Why the cell runs P = 6: a solve in a precision of unit roundoff u
    keeps about -log10(cond * u) digits.  At P = 6 float32 keeps some on
    every drawn range (cond <= 1.1e7 < 2**24); at P = 7 it keeps none on
    the narrowest; at P = 16 even float64 keeps under one digit on the
    best-conditioned range (cond >= 1.8e15, cond * 2**-53 > 0.1), so a
    float64 Kuu solve does not cure P = 16."""
    assert kuu_conds(6)[1] < 2.0 ** 24
    assert kuu_conds(7)[1] > 2.0 ** 24
    assert kuu_conds(16)[0] * 2.0 ** -53 > 0.1


def _rounding(shape):
    """Per axis: what conv2 and conv4 floor away, and the decoder's crop."""
    crop = reference.decoder_seed_shape(shape)[1]
    out = []
    for i, c in zip(shape, crop):
        a = (i - 5) // 2 + 1 - 2            # conv3's output (conv1, conv3: k3, s1)
        out.append(((i - 5) % 2, (a - 3) % 2, c))
    return out


def test_the_grid_rounds_as_the_mni_grid():
    assert _rounding(GRID) == _rounding(MNI)
    assert reference.decoder_seed_shape(MNI)[1] == (2, 0, 0)
    assert min(reference.encoder_out_shape(GRID)) >= 1
    # the smallest such grid: one less step of 4 on any axis leaves no encoder
    for axis in range(3):
        smaller = tuple(n - 4 * (k == axis) for k, n in enumerate(GRID))
        assert min(reference.encoder_out_shape(smaller)) < 1


@pytest.mark.parametrize("seed", [7, 2**31 + 16])
def test_port_step_matches_the_reference_at_the_mni_rounding(seed):
    from vaegam_tpu_torch.models import forward

    _, cfg, traffic = harness.load_cell("mni91-train-eager")
    assert cfg["img_shape"] == list(MNI) and cfg["num_inducing_pts"] == 6
    cfg = dict(cfg, nf=2, num_latents=8, img_shape=list(GRID))
    f64, b = torch.float64, 2
    data = study.make_study(traffic, GRID, cfg["num_covariates"], seed)
    params = {k: v.to(f64) for k, v in
              reference.flatten(reference.make_params(cfg, seed, "cpu")).items()}
    consts = reference.make_consts(cfg, data["xu_ranges"], data["glm_maps"], "cpu", f64)
    noise = tuple(n.to(f64) for n in
                  reference.draw_noise(torch.Generator().manual_seed(seed), b, cfg, "cpu"))
    covs = torch.as_tensor(data["covariates"][:b]).to(f64)
    x = torch.as_tensor(data["volumes"][:b]).to(f64)

    def step(loss_of):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = loss_of(reference.unflatten(leaves))
        return loss.item(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    # float64 tensors through the float32 configuration: every operation,
    # the norm statistics included, runs in float64 (conv5 in its plain
    # version on the CPU)
    port_loss, port = step(lambda p: forward(p, consts, covs, x, harness.port_config(cfg),
                                             noise=noise)[0])
    ref_loss, ref = step(lambda p: reference.step_loss(p, consts, covs, x, noise, cfg)[0])

    assert abs(port_loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert port.keys() == ref.keys()
    median = statistics.median(float(g.norm()) for g in ref.values())
    for k, g in ref.items():
        gap = float((port[k] - g).norm())
        if k in KERNEL_LEAVES:
            assert gap <= KERNEL_TOL * max(float(g.norm()), median), k
        else:
            assert gap <= LEAF_TOL * float(g.norm()), k
