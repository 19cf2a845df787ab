"""The traffic generator: a synthetic fMRI study from a traffic file and a seed.

A traffic file (``traffic/<name>.json``) gives the study's size (subjects x
volumes a subject), how it is fed (batch size, loader, ``epoch_scan``) and
the distributions its data are drawn from.  One seed gives one study; every
seed gives a study of the same sizes, so the work of a run does not depend
on the seed.  The data follow the synthetic studies the port's card checks
use: volumes uniform in [0, 1] (the CLI's /3284.5-scaled intensities lie
there), a task regressor that is on or off, six motion regressors, a sex
regressor fixed per subject, and GLM maps of normals.
"""

from __future__ import annotations

import numpy as np

MOTION = slice(1, 7)


def seed_bits(seed: int) -> int:
    """Any whole number as a non-negative 32-bit seed: the Trainer's PRNG
    key holds 32 bits, and the study, the weights and the reference's
    draws all take this one number."""
    return int(seed) % (1 << 32)


def make_study(traffic: dict, img_shape, num_covariates: int, seed: int) -> dict:
    """Host arrays of one study: ``volumes`` (N, D, H, W) float32,
    ``covariates`` (N, C) float32, ``subjid`` and ``vol_num`` (N,),
    ``glm_maps`` (D*H*W, C + 1) float32 (the reference's CSV with its index
    column first) and ``xu_ranges``, the CLI's inducing-point ranges
    (each motion regressor's [min - margin, max + margin])."""
    rng = np.random.default_rng(seed_bits(seed))
    subjects, per = traffic["subjects"], traffic["vols_per_subject"]
    n = subjects * per
    cov = traffic["covariates"]
    covs = (rng.standard_normal((n, num_covariates), dtype=np.float32)
            * np.float32(cov["motion_std"]))
    covs[:, 0] = rng.random(n) < cov["task_on"]
    sex = rng.random(subjects) < cov["sex_on"]
    covs[:, 7] = np.repeat(sex, per)
    vol = traffic["volume"]
    vols = rng.random((n, *img_shape), dtype=np.float32)
    vols *= np.float32(vol["high"] - vol["low"])
    vols += np.float32(vol["low"])
    img_dim = int(np.prod(img_shape))
    glm = (rng.standard_normal((img_dim, num_covariates + 1), dtype=np.float32)
           * np.float32(traffic["glm_std"]))
    margin = traffic["xu_margin"]
    motion = covs[:, MOTION]
    xu_ranges = [[float(lo) - margin, float(hi) + margin]
                 for lo, hi in zip(motion.min(0), motion.max(0))]
    return {"volumes": vols, "covariates": covs,
            "subjid": np.repeat(np.arange(subjects), per),
            "vol_num": np.tile(np.arange(per), subjects),
            "glm_maps": glm, "xu_ranges": xu_ranges}


def batch_widths(n: int, batch: int) -> list:
    """The widths of an epoch's steps: full batches and one tail."""
    return [min(batch, n - s) for s in range(0, n, batch)]
