"""The yardstick's arithmetic and its plain reference, on the CPU.

* The analytic step FLOPs (``flops.step_products``) against
  ``torch.utils.flop_counter.FlopCounterMode`` over one port step at a thin
  shape, op by op, with each difference explained:
  - the counter counts a transposed conv's every input-tap pair, the
    yardstick only those whose output lands inside the cropped output
    (convt2's padding (1, 0, 1));
  - on the CPU conv5's forward is the port's plain version, 27 einsums,
    which the counter sees as batched matmuls;
  - the counter sees the matmuls inside the Cholesky VJP and the LU
    solve's VJP (the yardstick leaves factorizations and solves out), and
    skips the solves themselves, as the yardstick does.
* conv5's bound at the main and MNI shapes.
* The plain reference against the port's step at a thin size.
"""

import math

import pytest
import torch
from conftest import THIN, thin_cell
from torch.utils.flop_counter import FlopCounterMode

from portbench import check, flops, reference, study


def _ops(counts):
    return {str(k).split(".")[-1].split("_default")[0]: v for k, v in counts.items()}


def _convt_counter_macs(cfg, rows):
    """Transposed convs as the counter counts them: every input voxel
    times every tap (no crop), with the exact count beside it."""
    nf, c = cfg["nf"], 2 * cfg["nf"]
    sp = reference.decoder_seed_shape(cfg["img_shape"])[0]
    counter = exact = 0
    for ci, co, k, s, pd, op in ((c, c, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0)),
                                 (c, c, (3, 3, 3), 2, (1, 0, 1), (1, 0, 1)),
                                 (c, nf, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0)),
                                 (nf, nf, (5, 3, 3), 2, (0, 0, 0), (0, 0, 0)),
                                 (nf, 1, (3, 3, 3), 1, (0, 0, 0), (0, 0, 0))):
        counter += rows * ci * co * math.prod(sp) * math.prod(k)
        macs, sp = flops.conv_macs(rows, ci, co, sp, k, (s,) * 3, pd, op, transposed=True)
        exact += macs
    return counter, exact


def test_step_flops_against_the_flop_counter():
    from portbench.harness import port_config
    from vaegam_tpu_torch.models import forward

    _, cfg, tr = thin_cell()
    b, n_cov, p = 8, cfg["num_covariates"], cfg["num_inducing_pts"]
    data = study.make_study(dict(tr, subjects=1, vols_per_subject=b), cfg["img_shape"],
                            n_cov, 3)
    params = reference.make_params(cfg, 3, "cpu")
    consts = reference.make_consts(cfg, data["xu_ranges"], data["glm_maps"], "cpu")
    leaves = list(reference.flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    noise = reference.draw_noise(torch.Generator().manual_seed(3), b, cfg, "cpu")
    with FlopCounterMode(display=False) as fc:
        loss, _ = forward(params, consts, torch.as_tensor(data["covariates"]),
                          torch.as_tensor(data["volumes"]), port_config(cfg), noise=noise)
        torch.autograd.grad(loss, leaves)
    got = _ops(fc.get_flop_counts()["Global"])
    prods = {name: (macs, passes) for name, macs, passes in flops.step_products(cfg, b)}

    linear = sum(m * ps for n, (m, ps) in prods.items() if "/fc" in n)
    assert got["addmm"] + got["mm"] == 2 * linear

    rows_d = (n_cov + 1) * b
    convt_counter, convt_exact = _convt_counter_macs(cfg, rows_d)
    assert convt_exact == sum(m for n, (m, _) in prods.items() if "convt" in n)
    assert convt_exact < convt_counter                     # convt2's cropped taps
    enc = {n: m for n, (m, _) in prods.items() if n.startswith("enc/conv")}
    hrf = prods["gain/hrf"][0]
    conv5 = enc.pop("enc/conv5")
    assert got["convolution"] == 2 * (sum(enc.values()) + convt_counter + hrf)
    assert got["convolution_backward"] == 2 * (
        2 * (sum(enc.values()) + conv5 + convt_counter) + hrf)

    # batched matmuls: conv5's plain forward, the einsums, the GP products,
    # the Cholesky VJP's matmul (four gain factorizations, the GP KL's) and
    # the Kuu solve's VJP (-grad_B X^T)
    einsums = sum(m * ps for n, (m, ps) in prods.items()
                  if n.startswith(("gp/", "compose", "glm/")) or n == "gain/l_eps")
    left_out = 4 * n_cov * b ** 3 + 6 * p ** 3 + 6 * p * b * p
    assert got["bmm"] == 2 * (conv5 + einsums + left_out)

    counted = sum(got.values())
    explained = counted - 2 * left_out - 6 * (convt_counter - convt_exact)
    assert explained == flops.step_flops(cfg, b)


@pytest.mark.parametrize("shape,bound_ms", [((32, 16, 8, 10, 6), 0.00042),
                                            ((4, 16, 20, 25, 20), 0.00134)])
def test_conv5_bound_at_the_main_and_mni_shapes(shape, bound_ms):
    # PERF.md's one-pass bounds, both bytes-bound: 4 bytes a word at 3.35e12 B/s
    assert flops.conv5_bound_s(shape) * 1e3 == pytest.approx(bound_ms, abs=5e-6)


def test_conv5_shapes_of_the_cells():
    from portbench.harness import load_cell

    assert flops.conv5_shape(load_cell("ref41-train-eager")[1], 32) == (32, 16, 8, 10, 6)
    # the MNI152 2 mm grid (91, 109, 91), a grid the benchmark has no cell on yet
    mni = dict(load_cell("ref41-train-eager")[1], img_shape=[91, 109, 91])
    assert flops.conv5_shape(mni, 8) == (8, 16, 20, 25, 20)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_reference_against_the_port_on_the_cpu(seed):
    from portbench.harness import port_config
    from vaegam_tpu_torch.models import forward

    _, cfg, tr = thin_cell()
    b = 8
    data = study.make_study(dict(tr, subjects=1, vols_per_subject=b), cfg["img_shape"],
                            cfg["num_covariates"], seed)
    params = reference.make_params(cfg, seed, "cpu")
    consts = reference.make_consts(cfg, data["xu_ranges"], data["glm_maps"], "cpu")
    leaves = reference.flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    noise = reference.draw_noise(torch.Generator().manual_seed(seed), b, cfg, "cpu")
    covs, x = torch.as_tensor(data["covariates"]), torch.as_tensor(data["volumes"])
    lp, _ = forward(params, consts, covs, x, port_config(cfg), noise=noise)
    lr, _ = reference.step_loss(params, consts, covs, x, noise, cfg)
    gp = torch.autograd.grad(lp, list(leaves.values()))
    gr = torch.autograd.grad(lr, list(leaves.values()))
    gaps = check._leaf_gaps(check._norms(dict(zip(leaves, gp))),
                            check._norms(dict(zip(leaves, gr))), list(leaves))
    assert check._rel(lp.item(), lr.item()) <= 1e-6
    assert check._median(gaps.values()) <= 1e-5


def test_the_reference_parameters_have_the_port_layout():
    from portbench.harness import port_config
    from vaegam_tpu_torch.models import init_model

    _, cfg, _ = thin_cell()
    theirs, _ = init_model(port_config(cfg), [[-2.0, 2.0]] * 6, device="cpu")
    ours = reference.make_params(cfg, 1, "cpu")
    assert {k: tuple(v.shape) for k, v in reference.flatten(theirs).items()} == \
        {k: tuple(v.shape) for k, v in reference.flatten(ours).items()}
    assert THIN["nf"] == cfg["nf"]
