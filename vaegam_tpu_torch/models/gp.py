"""Sparse 1-D inducing-point GP bank, batched over the motion covariates.

Counterpart of ``vaegam_tpu.models.gp``.  Where the JAX model vmaps one GP
over the 6 stacked motion covariates (vaegam.py:357-362), these functions
take the stack as a leading axis G:
  * RBF kernel   k(a,b) = k_var * exp(-((a-b) / (sqrt(2)*ls))^2)
  * posterior    A = Kuq^T Kuu^{-1};  f_bar = A qu_m;
                 Sigma = Kqq + A (qu_S - Kuu) A^T
  * KL           KL( N(qu_m, qu_S) || N(0, 10 I) )
The Kuu solve is an unguarded LU solve, as in the JAX code.
"""

from __future__ import annotations

import math

import torch

from .distributions import mvn_kl

GP_PRIOR_VAR = 10.0  # prior N(0, 10 I) over inducing outputs


def rbf_gram(x1, x2, k_var, ls):
    """x1: (G, n), x2: (G, m), k_var/ls: (G,) -> (G, n, m)."""
    diff = x1[:, :, None] - x2[:, None, :]
    scaled = diff / (math.sqrt(2.0) * ls[:, None, None])
    return k_var[:, None, None] * torch.exp(-torch.square(scaled))


def evaluate_posterior(xu, k_var, ls, qu_m, qu_S, xq):
    """Posterior q(f) over query points, for G stacked GPs.

    Args:
      xu: (G, P) inducing locations; k_var, ls: (G,) transformed scalars;
      qu_m: (G, P); qu_S: (G, P, P); xq: (G, B) query covariate values.

    Returns:
      f_bar: (G, B) posterior means;  Sigma: (G, B, B) covariances.
    """
    kuq = rbf_gram(xu, xq, k_var, ls)          # (G, P, B)
    kqq = rbf_gram(xq, xq, k_var, ls)          # (G, B, B)
    kuu = rbf_gram(xu, xu, k_var, ls)          # (G, P, P)
    a_t = torch.linalg.solve(kuu, kuq)         # (G, P, B)
    a = a_t.mT
    f_bar = (a @ qu_m[:, :, None])[..., 0]
    sigma = kqq + a @ (qu_S - kuu) @ a_t
    return f_bar, sigma


def gp_kl(qu_m, qu_S):
    """KL( N(qu_m, qu_S) || N(0, 10 I) ) per GP;  NaN if qu_S is not PSD."""
    return mvn_kl(qu_m, qu_S, GP_PRIOR_VAR)
