"""GP posterior plots + CSVs for the 6 motion covariates.

Counterpart of ``vaegam_tpu.outputs.gp_plots`` (reference
vae_reg_GP.py:622-689): for each motion covariate, evaluate the gain
posterior over ALL csv rows, write a CSV {epoch:03d}_GP_{cov}_full.csv
sorted by xq and a PDF GP_{cov}_full_set.pdf into {epoch:03d}_GP_plots/.
The six posteriors are one batched evaluation on the Trainer's device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pandas as pd
import torch

from ..models.gp import evaluate_posterior_diag
from ..models.vaegam import COVARIATE_KEYS, MOTION_SLICE, gp_transforms, resolve_qu_S
from ..utils.tb import pyplot

MOTION_CSV_COLS = ["x", "y", "z", "rot_x", "rot_y", "rot_z"]


def plot_GPs(trainer, csv_file: str = "", save_dir: str = ""):
    t0 = time.perf_counter()
    outdir_name = str(trainer.epoch).zfill(3) + "_GP_plots"
    plot_dir = os.path.join(save_dir, outdir_name)
    os.makedirs(plot_dir, exist_ok=True)

    data = pd.read_csv(csv_file)
    all_covariates = data[MOTION_CSV_COLS].to_numpy()

    gp_p = trainer.params["gp"]
    # Diag-only posterior: a study-sized CSV (1e4+ rows) would make the
    # dense (N, N) Sigma >= 400 MB per covariate
    with torch.no_grad():
        kvar, ls = gp_transforms(gp_p, trainer.config)
        xq = torch.as_tensor(all_covariates.T, dtype=gp_p["qu_m"].dtype,
                             device=trainer.device)
        f_bar, var = evaluate_posterior_diag(
            trainer.consts["xu"], kvar, ls, gp_p["qu_m"], resolve_qu_S(gp_p), xq)
    f_bar, var = f_bar.cpu().numpy(), var.cpu().numpy()
    xq = xq.cpu().numpy()
    sa = gp_p["sa"].detach().cpu().numpy()
    std = np.exp(gp_p["logstd"].detach().cpu().numpy())

    try:
        plt = pyplot()
    except ImportError as e:
        plt = None
        print(f"[outputs] GP_{{cov}}_full_set.pdf in {plot_dir} not written: {e}")
    for j, name in enumerate(COVARIATE_KEYS[MOTION_SLICE]):
        cov_idx = MOTION_SLICE.start + j  # position in the 8-covariate bank
        beta_mean = sa[cov_idx] * xq[j] + f_bar[j]
        beta_var = std[cov_idx] ** 2 * xq[j] ** 2 + var[j]
        frame = pd.DataFrame(
            {
                "xq": all_covariates[:, j],
                "mean": beta_mean.tolist(),
                "vars": beta_var.tolist(),
            }
        ).sort_values(by=["xq"])
        outfull_name = str(trainer.epoch).zfill(3) + "_GP_" + name + "_full.csv"
        frame.to_csv(os.path.join(plot_dir, outfull_name))
        if plt is None:
            continue

        plt.clf()
        plt.plot(frame["xq"], frame["mean"], c="darkblue", alpha=0.5,
                 label="Beta posterior mean")
        two_sigma = 2 * np.sqrt(np.maximum(frame["vars"], 0.0))
        plt.fill_between(frame["xq"], frame["mean"] - two_sigma,
                         frame["mean"] + two_sigma,
                         color="lightblue", alpha=0.3, label="2 sigma")
        plt.locator_params(axis="x", nbins=6)
        plt.locator_params(axis="y", nbins=4)
        plt.legend(loc="best")
        plt.title(f"GP Plot {name}_full_set")
        plt.xlabel("Covariate")
        plt.ylabel("Beta Ouput")
        plt.savefig(os.path.join(plot_dir, f"GP_{name}_full_set.pdf"))
    trainer.output_stats["gp_plots_s"] = time.perf_counter() - t0
