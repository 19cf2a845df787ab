"""Distribution math for the VAE-GAM, on torch tensors.

Counterpart of ``vaegam_tpu.models.distributions``.  Noise always enters as
a tensor argument; no function here draws random numbers itself.

Non-PSD Cholesky: ``jnp.linalg.cholesky`` returns a factor whose lower
triangle is all NaN (zeros above) for a matrix that is not positive
definite, and its gradient for that matrix is NaN too.  Two places rely on
that: ``mvn_sample_safe`` picks its jitter fallback from the NaN, and
``mvn_kl``'s NaN makes the optimizer skip the step.  ``torch.linalg.cholesky``
raises instead, so :func:`cholesky_nan` reproduces the JAX behaviour on top
of ``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import math

import torch

from ..ops import products

_LOG_2PI = math.log(2.0 * math.pi)


class _CholeskyNaN(torch.autograd.Function):
    """Lower Cholesky factor; NaN lower triangle where the factorization fails.

    The backward is torch's own Cholesky VJP (Murray 2016), evaluated on the
    NaN-filled factor, so a failed matrix gets a NaN gradient as it does
    under JAX.
    """

    @staticmethod
    def forward(ctx, a):
        chol, info = torch.linalg.cholesky_ex(a)
        bad = (info != 0)[..., None, None]
        chol = torch.where(bad, torch.full_like(chol, float("nan")).tril(), chol)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, g):
        (chol,) = ctx.saved_tensors
        ga = (chol.mH @ g).tril()
        ga = 0.5 * (ga + ga.tril(-1).mH)
        ga = torch.linalg.solve_triangular(chol.mH, ga, upper=True, left=True)
        ga = torch.linalg.solve_triangular(chol, ga, upper=False, left=False)
        return ga


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.cholesky`` semantics: symmetrized input, NaN on failure."""
    return _CholeskyNaN.apply(0.5 * (a + a.mT))


# ---------------------------------------------------------------------------
# Rank-1 low-rank multivariate normal  q(z) = N(mu, u u^T + diag(d))
# ---------------------------------------------------------------------------

def lowrank_mvn_kl_to_std_normal(mu, u, d):
    """Exact KL( N(mu, u u^T + diag(d)) || N(0, I) ), elementwise over batch.

    Matrix determinant lemma for the rank-1 update:
        logdet(diag(d) + u u^T) = sum(log d) + log(1 + sum(u^2 / d))
    """
    k = mu.shape[-1]
    tr = torch.sum(d, dim=-1) + torch.sum(u * u, dim=-1)
    quad = torch.sum(mu * mu, dim=-1)
    logdet = torch.sum(torch.log(d), dim=-1) + torch.log1p(
        torch.sum(u * u / d, dim=-1)
    )
    return 0.5 * (tr + quad - k - logdet)


# ---------------------------------------------------------------------------
# Dense multivariate normal (the batch-coupled gain sample)
# ---------------------------------------------------------------------------

def mvn_sample_safe(eps, mean, cov, jitters=(1e-4, 1e-3, 1e-2), tpu_products=False):
    """Sample N(mean, cov) as mean + L eps, with escalating-jitter fallback.

    eps: (..., n) standard-normal noise; mean: (..., n); cov: (..., n, n).
    The first factorization uses cov as given; matrices whose factor is NaN
    retry with progressively larger diagonal jitter.  Returns
    (sample, fallback_count) where fallback_count (int32 scalar tensor) is
    the number of matrices whose as-given factorization failed.
    ``tpu_products`` forms L eps in the TPU's arithmetic.
    """
    cov = 0.5 * (cov + cov.mT)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    chol = cholesky_nan(cov)
    first_bad = torch.isnan(chol).any(dim=-1).any(dim=-1)
    for j in jitters:
        bad = torch.isnan(chol).any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
        cand = cholesky_nan(cov + j * eye)
        chol = torch.where(bad, cand, chol)
    out = mean + products.ops(tpu_products).einsum("...ij,...j->...i", chol, eps)
    return out, first_bad.sum(dtype=torch.int32)


def mvn_kl(mu_q, cov_q, prior_var):
    """KL( N(mu_q, cov_q) || N(0, prior_var * I) ), Cholesky-based.

    A non-PSD cov_q yields NaN (see :func:`cholesky_nan`).
    """
    n = mu_q.shape[-1]
    chol = cholesky_nan(cov_q)
    logdet_q = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )
    tr = torch.diagonal(cov_q, dim1=-2, dim2=-1).sum(-1) / prior_var
    quad = torch.sum(mu_q * mu_q, dim=-1) / prior_var
    return 0.5 * (tr + quad - n + n * math.log(prior_var) - logdet_q)


# ---------------------------------------------------------------------------
# Univariate normals
# ---------------------------------------------------------------------------

def normal_log_prob(x, loc, scale):
    """Elementwise log N(x | loc, scale^2) (scale is the std dev)."""
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI


def normal_kl(mu_q, sigma_q, mu_p, sigma_p):
    """KL( N(mu_q, sigma_q^2) || N(mu_p, sigma_p^2) ), elementwise."""
    var_ratio = (sigma_q / sigma_p) ** 2
    t1 = ((mu_q - mu_p) / sigma_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
