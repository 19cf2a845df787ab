"""Beta-map GLM solve precision: the port's two solves against float64
normal equations, on an ill-conditioned FSL-scale fixture.

Counterpart of ``vaegam_tpu.tools.beta_solve_precision_study``.  The
reference solves the GLM normal equations in float64 numpy
(get_beta_map_regularizer.py:94-96: beta = inv(G^T G) G^T Y^T).  The
port's ``cli.beta_maps.solve_beta_maps`` has two arms: float64 lstsq on
the host (the default) and float32 ``torch.linalg.lstsq`` on the device.
Real FSL inputs are harsh: ~1e3-1e4-magnitude values, six mutually
correlated smooth motion drifts, ten subjects stacked to ~1e3 rows.  The
fixture is such a stack; the drift of each arm after max-scaling (what
feeds the training loss through glm_reg) is measured against the float64
normal-equation betas.

    python -m vaegam_tpu_torch.tools.beta_solve_precision_study [--n_subj 10]

Prints one JSON line: each arm's max / median / p99 drift, and the
fixture's condition number.
"""

from __future__ import annotations

import argparse

import numpy as np

from .._device import resolve_device
from ..cli.beta_maps import solve_beta_maps
from ..utils.signals import hrf, stimulus_to_neural
from ..utils.stats import scale_beta_maps
from .common import emit


def make_realistic_fixture(n_subj=10, n_t=98, n_vox=70315, seed=0, corr=0.98,
                           value_scale=8000.0):
    """(gamma (sum_T, 7), Y (voxels, sum_T)): an HRF-convolved block task
    column; six motion columns sharing a smooth random-walk drift (pairwise
    correlation ~`corr`, translations ~mm, rotations ~radians, as FSL's
    design.mat holds them); betas ~ N(0, 50) on 512 active voxels, noise,
    and filtered_func_data's baseline offset."""
    rng = np.random.default_rng(seed)
    tr = 1.4
    times = np.arange(1, n_t + 1) * tr
    task = np.convolve(stimulus_to_neural(times).astype(np.float64),
                       hrf(np.arange(0, 20, tr)))[:n_t]
    designs = []
    for _ in range(n_subj):
        base = np.cumsum(rng.normal(size=n_t))
        base = np.convolve(base, np.ones(9) / 9.0, mode="same")
        base = (base - base.mean()) / (base.std() + 1e-12)
        mot = np.empty((n_t, 6))
        for j in range(6):
            indep = np.cumsum(rng.normal(size=n_t))
            indep = (indep - indep.mean()) / (indep.std() + 1e-12)
            col = corr * base + np.sqrt(1.0 - corr ** 2) * indep
            mot[:, j] = (0.5 if j < 3 else 5e-3) * col
        designs.append(np.column_stack([task, mot]))
    gamma = np.concatenate(designs, axis=0)
    true_beta = np.zeros((7, n_vox))
    active = rng.choice(n_vox, size=min(512, n_vox), replace=False)
    true_beta[:, active] = rng.normal(scale=50.0, size=(7, active.size))
    y = gamma @ true_beta
    y += rng.normal(scale=25.0, size=y.shape)
    y += value_scale
    return gamma, y.T.copy()


def reference_solve_f64(gamma: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """The reference's computation (get_beta_map_regularizer.py:94-96)."""
    g = gamma.astype(np.float64)
    return np.linalg.inv(g.T @ g) @ g.T @ filtered.T.astype(np.float64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_subj", type=int, default=10)
    p.add_argument("--n_vox", type=int, default=70315)
    p.add_argument("--corr", type=float, default=0.98)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the float32 arm's device; default: the CUDA device, 'cpu' the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    gamma, y = make_realistic_fixture(n_subj=args.n_subj, n_vox=args.n_vox,
                                      corr=args.corr, seed=args.seed)
    ref = scale_beta_maps(reference_solve_f64(gamma, y))
    results = {"tool": "beta_solve_precision_study", "device": str(device),
               "cond_gamma": float(np.linalg.cond(gamma)), "sum_T": gamma.shape[0],
               "n_vox": args.n_vox}
    for dtype in ("float32", "float64"):
        drift = np.abs(scale_beta_maps(solve_beta_maps(gamma, y, dtype=dtype,
                                                       device=device)) - ref)
        results[dtype] = {"max_drift": float(drift.max()),
                          "median_drift": float(np.median(drift)),
                          "p99_drift": float(np.quantile(drift, 0.99))}
    return emit(results)


if __name__ == "__main__":
    main()
