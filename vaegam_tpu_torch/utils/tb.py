"""TensorBoard figure and image loggers (reference utils.py:182-389).

The port's copy of ``vaegam_tpu.utils.tb``: the same tags and figure
content, parameterized over the covariate bank and fed host numpy copies of
the parameters.  Strictly host-side.

The writer is ``torch.utils.tensorboard.SummaryWriter`` (tensorboardX's API
and event format, shipped with torch; it needs the ``tensorboard``
package).  matplotlib, scipy and the writer are imported inside the
functions that use them, so the port imports without them; a function whose
library is absent raises ImportError and the caller names what it could not
write.

Tags kept for parity:
  q(u)_{log_type}, q(k)_{log_type}, Beta/{cov}_{log_type},
  {map}_{log_type}_{slice}/{i}, Loss/Train,
written as tensorboardX writes them (q(u)_train becomes q_u__train).
"""

from __future__ import annotations

import re

import numpy as np

from ..models.vaegam import COVARIATE_KEYS, MOTION_SLICE

_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(tag: str) -> str:
    """tensorboardX's rule for summary names: each character outside
    [-/\\w.] becomes '_' and leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_writer(log_dir: str):
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(log_dir=log_dir)


def log_qu_plots(epoch, gp_np, xu_np, writer, log_type):
    """3x2 grid of q(u) posterior mean +-2 sigma per motion covariate."""
    plt = pyplot()
    fig, axs = plt.subplots(3, 2, figsize=(15, 15))
    for j, name in enumerate(COVARIATE_KEYS[MOTION_SLICE]):
        ax = axs[j // 2, j % 2]
        xu = np.asarray(xu_np[j])
        qu_m = np.asarray(gp_np["qu_m"][j]).reshape(-1)
        qu_var = np.diag(np.asarray(gp_np["qu_S"][j]))
        two_sigma = 2 * np.sqrt(np.maximum(qu_var, 0.0))
        ax.plot(xu, qu_m, c="darkblue", alpha=0.5, label="q(u) posterior mean")
        ax.fill_between(xu, qu_m - two_sigma, qu_m + two_sigma,
                        color="lightblue", alpha=0.3, label="2 sigma")
        ax.legend(loc="best")
        ax.set_title(f"q(u) {name} covariate at epoch {epoch}")
        ax.set_xlabel(f"Covariate {name} -- x vals ")
        ax.set_ylabel("q(u)")
    writer.add_figure(clean_tag(f"q(u)_{log_type}"), fig)
    plt.close(fig)


def log_qkappa_plots(gp_np, writer, log_type):
    """3x3 grid of q(kappa) posterior pdfs for all 8 covariates."""
    from scipy.stats import norm

    plt = pyplot()
    fig, axs = plt.subplots(3, 3, figsize=(15, 15))
    colors = ["green", "blue", "orange", "red", "violet", "magenta",
              "purple", "cyan"]
    sa = np.asarray(gp_np["sa"]).reshape(-1)
    std = np.exp(np.asarray(gp_np["logstd"]).reshape(-1))
    for j, name in enumerate(COVARIATE_KEYS):
        ax = axs[j // 3, j % 3]
        gauss = norm(sa[j], scale=std[j])
        xs = np.linspace(gauss.ppf(0.01), gauss.ppf(0.99), 100)
        ax.plot(xs, gauss.pdf(xs), lw=2, alpha=0.5, color=colors[j])
        ax.set_title(f"{name.capitalize()} q(k)")
    writer.add_figure(clean_tag(f"q(k)_{log_type}"), fig)
    plt.close(fig)


def log_beta(writer, xq, beta_mean, beta_cov_diag, covariate_name, log_type):
    """Sorted beta posterior mean +-2 sigma for one covariate, one batch."""
    plt = pyplot()
    xq = np.asarray(xq)
    mean = np.asarray(beta_mean)
    two_sigma = 2 * np.sqrt(np.maximum(np.asarray(beta_cov_diag), 0.0))
    order = np.argsort(xq)
    fig = plt.figure()
    plt.plot(xq[order], mean[order], c="darkblue", alpha=0.5,
             label="Beta posterior mean")
    plt.fill_between(xq[order], mean[order] - two_sigma[order],
                     mean[order] + two_sigma[order],
                     color="lightblue", alpha=0.3, label="2 sigma")
    plt.legend(loc="best")
    plt.title(f"Beta_{covariate_name}")
    plt.xlabel("Covariate")
    plt.ylabel("Beta Ouput")
    writer.add_figure(clean_tag(f"Beta/{covariate_name}_{log_type}"), fig)
    plt.close(fig)


def log_map(writer, img_shape, map_arr, slice_idx, map_name, batch_size,
            log_type):
    """Sagittal slice images (rotated 90 deg) for each batch element."""
    from scipy import ndimage

    map_arr = np.asarray(map_arr).reshape((batch_size,) + tuple(img_shape))
    for i in range(batch_size):
        slc = ndimage.rotate(map_arr[i, slice_idx, :, :], 90)
        writer.add_image(
            clean_tag(f"{map_name}_{log_type}_{slice_idx}/{i}"), slc,
            dataformats="HW"
        )
