"""Sparse 1-D inducing-point GP bank, batched over the motion covariates.

Counterpart of ``vaegam_tpu.models.gp``.  Where the JAX model vmaps one GP
over the 6 stacked motion covariates (vaegam.py:357-362), these functions
take the stack as a leading axis G:
  * RBF kernel   k(a,b) = k_var * exp(-((a-b) / (sqrt(2)*ls))^2)
  * posterior    A = Kuq^T Kuu^{-1};  f_bar = A qu_m;
                 Sigma = Kqq + A (qu_S - Kuu) A^T
  * KL           KL( N(qu_m, qu_S) || N(0, 10 I) )
The Kuu solve is an unguarded LU solve, as in the JAX code: ``solve_ex``
without its error check, so a singular Kuu gives non-finite values (which
the Trainer's skip rule then handles) where ``torch.linalg.solve`` would
raise, and no step reads the factorization's status on the host.

``tpu_products`` computes the products around the solve in the TPU's
arithmetic (``ops.products``), as the same pairwise contractions as JAX's;
the solve stays in full precision.
"""

from __future__ import annotations

import math

import torch

from ..ops import products
from .distributions import mvn_kl

GP_PRIOR_VAR = 10.0  # prior N(0, 10 I) over inducing outputs


def rbf_gram(x1, x2, k_var, ls):
    """x1: (G, n), x2: (G, m), k_var/ls: (G,) -> (G, n, m)."""
    diff = x1[:, :, None] - x2[:, None, :]
    scaled = diff / (math.sqrt(2.0) * ls[:, None, None])
    return k_var[:, None, None] * torch.exp(-torch.square(scaled))


def evaluate_posterior(xu, k_var, ls, qu_m, qu_S, xq, tpu_products: bool = False):
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
    a_t = torch.linalg.solve_ex(kuu, kuq).result   # (G, P, B)
    a = a_t.mT
    mm = products.ops(tpu_products).matmul
    f_bar = mm(a, qu_m[:, :, None])[..., 0]
    sigma = kqq + mm(mm(a, qu_S - kuu), a_t)
    return f_bar, sigma


def evaluate_posterior_diag(xu, k_var, ls, qu_m, qu_S, xq, tpu_products: bool = False):
    """Posterior mean and MARGINAL variance over xq, without the (B, B) Sigma.

    The diagonal of :func:`evaluate_posterior`:
      diag(Sigma) = k_var + sum_pq a_t[p,b] (qu_S - Kuu)[p,q] a_t[q,b]
    (the RBF at zero distance is k_var).  O(B P) memory, so plot_GPs can
    evaluate a study's every CSV row.  Shapes as :func:`evaluate_posterior`;
    returns f_bar (G, B) and var (G, B).  ``tpu_products`` contracts the
    three-operand sum as JAX's einsum path does, (qu_S - Kuu) with a_t
    first, then a_t with that, each product in the TPU's arithmetic.
    """
    kuq = rbf_gram(xu, xq, k_var, ls)          # (G, P, B)
    kuu = rbf_gram(xu, xu, k_var, ls)          # (G, P, P)
    a_t = torch.linalg.solve_ex(kuu, kuq).result   # (G, P, B)
    if tpu_products:
        f_bar = products.matmul(a_t.mT, qu_m[:, :, None])[..., 0]
        m_a = products.einsum("gpq,gpb->gqb", qu_S - kuu, a_t)
        return f_bar, k_var[:, None] + products.einsum("gqb,gqb->gb", a_t, m_a)
    f_bar = (a_t.mT @ qu_m[:, :, None])[..., 0]
    var = k_var[:, None] + torch.einsum("gpb,gpq,gqb->gb", a_t, qu_S - kuu, a_t)
    return f_bar, var


def gp_kl(qu_m, qu_S):
    """KL( N(qu_m, qu_S) || N(0, 10 I) ) per GP;  NaN if qu_S is not PSD."""
    return mvn_kl(qu_m, qu_S, GP_PRIOR_VAR)
