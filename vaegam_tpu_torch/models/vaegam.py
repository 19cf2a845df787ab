"""VAE-GAM core: parameter bank and composite ELBO forward pass, in torch.

Counterpart of ``vaegam_tpu.models.vaegam`` (reference vae_reg_GP.py:35-413)
with the same math and the same implementation choices:
  * the base map and the 8 covariate effect maps decode as ONE (9*B)-row
    batch, with per-one-hot norm statistics unless ``fused_norm_stats``;
  * the 6 motion-covariate GP posteriors are one batched evaluation;
  * the per-covariate B x B gain samples are one batched Cholesky;
  * the GLM regularizer's sum of distances is taken in closed form.
The forward's random draws enter as explicit tensors (``noise``) or come
from an explicit ``torch.Generator``; the initial parameters are the JAX
package's for the same PRNG key; parameters live in one nested dict of
tensors.

Reference quirks kept on purpose: the global d-floor, the HRF convolution
over the BATCH axis, GLM columns 1..8 of the CSV read with its index column.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import products
from ..ops.packed_conv import check_pack
from ..utils import prng
from ..utils.signals import hrf
from . import gp as gp_mod
from .distributions import (
    lowrank_mvn_kl_to_std_normal,
    mvn_sample_safe,
    normal_kl,
    normal_log_prob,
)
from ..parallel.mesh import (all_reduce_max, all_reduce_total, batch_rows, global_value,
                             mean_cotangent)
from .networks import decode, encode, init_decoder, init_encoder

# output map keys, in reference order
MAP_KEYS = (
    "base", "task", "x_mot", "y_mot", "z_mot",
    "pitch_mot", "roll_mot", "yaw_mot", "sex", "full_rec",
)

# gp_params covariate key order
COVARIATE_KEYS = ("task", "x", "y", "z", "xrot", "yrot", "zrot", "sex")
MOTION_SLICE = slice(1, 7)  # the 6 motion covariates within COVARIATE_KEYS

TR_SECONDS = 1.4
HRF_WINDOW_SECONDS = 20.0

@dataclasses.dataclass(frozen=True)
class VAEGAMConfig:
    """Static model configuration; fields and defaults as the JAX package's.

    ``conv_dtype`` is None (fp32, the parity path) or a torch dtype such as
    ``torch.bfloat16`` for the conv stacks; ``enc_conv_dtype`` /
    ``dec_conv_dtype`` override it per stack ("inherit", None for fp32, or
    a dtype) and ``dec_fp32_final`` keeps the decoder's last conv in fp32.
    ``conv5_kernel`` (JAX: ``pallas_conv5``) routes the encoder's fp32 conv5
    through the hand-written CUDA kernel; it defaults to on, since the JAX
    default of off was a TPU measurement.  ``qu_s_cholesky`` parameterizes
    each GP posterior covariance as L L^T (``gp["qu_S_raw"]``);
    ``x64_epsilon`` stores epsilon in float64 (Adam updates it in float64,
    the log-likelihood reads it as float32), as the reference does.
    ``conv_pack=(s_h, s_w)`` lane-packs the stride-1 convs of both stacks
    (``ops.packed_conv``: the same math; off by default, a measured arm).
    ``dtype`` float64 builds every parameter and const in float64 and runs
    the model as JAX's float64 does: the norm statistics and the decoder's
    sigmoid in float32, the rest in float64.  It needs ``conv5_kernel``
    off (the kernel is float32, as JAX's Pallas conv5 is) and host batches
    (the device cache's gather restores float32 only).
    ``tpu_products`` computes every product that JAX's step computes as a
    ``dot_general`` or ``conv_general_dilated`` in the arithmetic of the
    TPU that made the JAX package's records (``ops.products``: both
    operands rounded to bfloat16, the sums in float32, forward and
    backward; conv5's kernel takes its one-pass bfloat16 path).  Cholesky,
    the LU solve and the triangular solves stay in full precision.  Off by
    default; in float64 it rounds the operands and sums in float64.
    """

    nf: int = 8
    num_covariates: int = 8
    num_latents: int = 32
    num_inducing_pts: int = 6
    gp_kl_scale: float = 10.0
    glm_reg_scale: float = 1.0
    neural_covariates: bool = True
    max_ls: float = 3.0
    img_shape: Tuple[int, int, int] = (41, 49, 35)
    dtype: Any = torch.float32
    conv_dtype: Any = None
    conv_pack: Any = None
    enc_conv_dtype: Any = "inherit"
    dec_conv_dtype: Any = "inherit"
    dec_fp32_final: bool = False
    conv5_kernel: bool = True
    qu_s_cholesky: bool = False
    x64_epsilon: bool = False
    fused_norm_stats: bool = False
    tpu_products: bool = False

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {self.dtype}: float32 or float64")
        if self.dtype == torch.float64 and self.conv5_kernel:
            raise ValueError(
                "a float64 model needs conv5_kernel=False: the conv5 kernel "
                "is float32, as the JAX package's Pallas conv5 is")
        if self.conv_pack is not None:
            pack = tuple(int(s) for s in self.conv_pack)
            check_pack(3, 3, pack)  # every packed layer's H x W kernel is 3x3
            object.__setattr__(self, "conv_pack", pack)

    @property
    def enc_cd(self):
        """The encoder's conv dtype after the per-stack override."""
        return self.conv_dtype if self.enc_conv_dtype == "inherit" else self.enc_conv_dtype

    @property
    def dec_cd(self):
        """The decoder's conv dtype after the per-stack override."""
        return self.conv_dtype if self.dec_conv_dtype == "inherit" else self.dec_conv_dtype

    @property
    def np_dtype(self):
        """The parameters' numpy dtype."""
        return np.float64 if self.dtype == torch.float64 else np.float32

    @property
    def stat_dtype(self):
        """The norm statistics' and the sigmoid's dtype: float32 for a
        float64 model (JAX's casts); None lets them follow the tensors."""
        return torch.float32 if self.dtype == torch.float64 else None

    @property
    def z_dim(self) -> int:
        return self.num_latents + self.num_covariates + 1

    @property
    def img_dim(self) -> int:
        return int(np.prod(self.img_shape))

    @property
    def num_neural(self) -> int:
        """How many leading covariates get HRF convolution (task, by default)."""
        return max(0, self.num_covariates - 7)


def hrf_kernel(device=None, dtype=torch.float32) -> torch.Tensor:
    """HRF sampled at TR resolution over a 20 s window (15 taps)."""
    return torch.tensor(hrf(np.arange(0.0, HRF_WINDOW_SECONDS, TR_SECONDS)),
                        dtype=dtype, device=device)


def init_model(
    config: VAEGAMConfig,
    xu_ranges,
    glm_maps: Optional[np.ndarray] = None,
    seed: int = 0,
    key: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Build (params, consts): nested dicts of tensors on `device`.

    The parameters are the JAX package's ``init_model`` for the same key:
    drawn with JAX's PRNG (``utils.prng``, in numpy) in its layout and key
    order, then mapped to the port's layout by ``params_from_jax``.

    Args:
      xu_ranges: 6 [lo, hi] ranges for the inducing-point grids.
      glm_maps:  optional (img_dim, num_covariates+1) array, the reference's
                 CSV read with its index column; None disables the GLM term.
      key:       a JAX PRNG key (uint32 pair); default ``PRNGKey(seed)``.
      device:    the CUDA device unless given (``"cpu"`` for the CPU).
    """
    from ..utils.jax_params import params_from_jax

    device = resolve_device(device)
    key = prng.prng_key(seed) if key is None else key
    k_enc, k_dec, k_sa, k_ls, k_qm = prng.split(key, 5)
    n_cov, p, n_mot = config.num_covariates, config.num_inducing_pts, 6
    dt = config.np_dtype
    gp_bank = {
        # linear gain for ALL covariates: sa ~ N(1,1), logstd ~ N(0,1)
        "sa": dt(1.0) + prng.normal(k_sa, (n_cov,), dt),
        "logstd": prng.normal(k_ls, (n_cov,), dt),
        # sparse-GP bank for the 6 motion covariates
        "qu_m": prng.normal(k_qm, (n_mot, p), dt),
        "logkvar": np.zeros(n_mot, dt),
        "log_ls": np.zeros(n_mot, dt),
    }
    if config.qu_s_cholesky:
        # raw factor with an exp diagonal, L = sqrt(2) I: L L^T = 2 I
        gp_bank["qu_S_raw"] = np.tile(
            np.diag(np.full(p, 0.5 * math.log(2.0), dt)), (n_mot, 1, 1))
    else:
        gp_bank["qu_S"] = np.tile(2.0 * np.eye(p, dtype=dt), (n_mot, 1, 1))
    tree = {
        "enc": init_encoder(k_enc, config.nf, config.num_latents, config.img_shape, dt),
        "dec": init_decoder(k_dec, config.nf, config.z_dim, config.img_shape, dt),
        "epsilon": np.full(config.img_shape, -math.log(10.0),
                           np.float64 if config.x64_epsilon else dt),
        "gp": gp_bank,
    }
    params, _ = params_from_jax(tree, None, config, device)
    xu = torch.stack([
        torch.linspace(float(lo), float(hi), p, dtype=config.dtype, device=device)
        for lo, hi in xu_ranges
    ])
    consts = {
        "xu": xu,
        "hrf": hrf_kernel(device, config.dtype),
        "glm_maps": (None if glm_maps is None else
                     torch.as_tensor(np.asarray(glm_maps, dt), device=device)),
    }
    return params, consts


def gp_transforms(gp_params, config: VAEGAMConfig):
    """kvar = exp(logkvar)+0.1;  ls = max_ls * sigmoid(exp(log_ls)+0.5)."""
    kvar = torch.exp(gp_params["logkvar"]) + 0.1
    ls = config.max_ls * torch.sigmoid(torch.exp(gp_params["log_ls"]) + 0.5)
    return kvar, ls


def resolve_qu_S(gp_params, tpu_products: bool = False) -> torch.Tensor:
    """The GP posterior covariance stack (6, P, P).

    The raw-matrix parameterization returns ``qu_S`` as it is; the Cholesky
    one returns L L^T with L = tril(raw, -1) + diag(exp(diag(raw))), PSD by
    construction.  The key present decides, as in the JAX package, so a
    checkpoint of either parameterization runs under either config.
    ``tpu_products`` forms L L^T in the TPU's arithmetic.
    """
    if "qu_S" in gp_params:
        return gp_params["qu_S"]
    raw = gp_params["qu_S_raw"]
    chol = torch.tril(raw, -1) + torch.diag_embed(
        torch.exp(torch.diagonal(raw, dim1=-2, dim2=-1)))
    return products.ops(tpu_products).einsum("cij,ckj->cik", chol, chol)


def hrf_convolve(gains: torch.Tensor, kernel: torch.Tensor,
                 tpu_products: bool = False) -> torch.Tensor:
    """Causal HRF convolution of each row of gains (n, B) over the batch axis.

    The first B entries of the full 1-D convolution (the JAX code's
    ``jnp.convolve(g, h, "full")[:B]``): a cross-correlation with the
    flipped kernel after K-1 zeros of left padding.

    ``tpu_products``: in the TPU's arithmetic, as JAX's convolve is a
    ``conv_general_dilated``, with its operands in JAX's order: the longer
    one is the conv's input, so a batch shorter than the kernel makes the
    kernel the input and each row of gains a (flipped) filter.
    """
    k, b = kernel.shape[0], gains.shape[1]
    if tpu_products and b < k:
        padded = F.pad(kernel[None, None, :], (b - 1, b - 1))
        return products.conv1d(padded, gains.flip(-1)[:, None, :])[0, :, :b]
    padded = F.pad(gains[:, None, :], (k - 1, 0))
    return products.ops(tpu_products).conv1d(padded, kernel.flip(0)[None, None, :])[:, 0, :]


def d_floor(d: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's global d-floor: if ANY element of the batch's d is
    below 1e-6, shift the WHOLE tensor by 1e-6 (under a mesh, any element
    of any rank's rows)."""
    tiny = (d < 1e-6).any()
    if mesh is not None:
        tiny = all_reduce_max(tiny.to(torch.int32), mesh) > 0
    return torch.where(tiny, d + 1e-6, d)


def draw_noise(generator: torch.Generator, batch: int, config: VAEGAMConfig,
               device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(eps_w (B,1), eps_d (B,L), eps_beta (C,B)) standard normals in the
    model's dtype."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=config.dtype,
                           device=device)

    return (randn(batch, 1), randn(batch, config.num_latents),
            randn(config.num_covariates, batch))


def forward(
    params: Dict[str, Any],
    consts: Dict[str, Any],
    covariates: torch.Tensor,  # (B, num_covariates)
    x: torch.Tensor,           # (B, *img_shape); this rank's rows under a mesh
    config: VAEGAMConfig,
    noise=None,
    generator: Optional[torch.Generator] = None,
    return_maps: bool = False,
    deterministic: bool = False,
    mesh=None,
):
    """Composite VAE-GAM objective (reference vae_reg_GP.py:307-413).

    Returns (tot_loss, aux), aux as in the JAX package: scalars elbo, gp_kl,
    glm_reg and diagnostics, plus 'z' and 'maps' (dict over MAP_KEYS of
    (B, img_dim)) when return_maps.

    The draws come from ``noise=(eps_w, eps_d, eps_beta)`` when given, else
    from ``generator``.  deterministic=True uses the means (z = mu,
    gains = beta_mean) and draws nothing.

    Data parallel: with a ``mesh`` (``parallel.DataMesh``) the covariates
    and the noise are the GLOBAL batch's (every rank draws the same) and x
    holds this rank's block of its volumes (``parallel.batch_rows``, uneven
    blocks allowed).  The value returned is the global batch's, as the
    single-process forward on the whole batch gives it: the norm statistics
    and the d-floor are reduced over the ranks, the gain sample (the B x B
    covariances, the jittered Cholesky, the HRF along the batch axis) is
    computed over the whole batch on every rank, which then keeps its own
    columns, and the loss sums the ranks' shares.  Its gradient is this
    rank's share (the replicated KL terms weighted 1/R), so the gradients
    summed over the ranks are the single-process ones.  ``aux``'s scalars
    and gain statistics are global; 'z' and the maps are this rank's rows.
    """
    b_all = covariates.shape[0]
    lo, hi = batch_rows(b_all, mesh, uneven=True)
    b = x.shape[0]
    if b != hi - lo:
        raise ValueError(f"{b} volume rows for rows [{lo}, {hi}) of a batch of {b_all}")
    n_cov = config.num_covariates
    if not deterministic and noise is None:
        if generator is None:
            raise ValueError("forward needs noise tensors or a generator")
        noise = draw_noise(generator, b_all, config, x.device)

    # --- encoder & latent sample ------------------------------------------
    tp = config.tpu_products
    op = products.ops(tp)
    mu, u, d = encode(params["enc"], x, config.conv5_kernel, config.enc_cd,
                      config.stat_dtype, mesh, b_all, config.conv_pack, tp)
    d = d_floor(d, mesh)
    if deterministic:
        z = mu
    else:
        eps_w, eps_d, eps_beta = noise
        z = mu + u * eps_w[lo:hi] + torch.sqrt(d) * eps_d[lo:hi]

    # --- ONE batched decode for base + all covariate effect maps ----------
    onehots = torch.eye(n_cov + 1, dtype=z.dtype, device=z.device)
    zb = z[None].expand(n_cov + 1, b, z.shape[-1])
    ohb = onehots[:, None, :].expand(n_cov + 1, b, n_cov + 1)
    zcat = torch.cat([zb, ohb], dim=-1).reshape((n_cov + 1) * b, config.z_dim)
    decoded = decode(
        params["dec"], zcat, config.img_shape,
        stat_groups=1 if config.fused_norm_stats else n_cov + 1,
        conv_dtype=config.dec_cd, fp32_final=config.dec_fp32_final,
        stat_dtype=config.stat_dtype, mesh=mesh, global_rows=(n_cov + 1) * b_all,
        conv_pack=config.conv_pack, tpu_products=tp,
    ).reshape(n_cov + 1, b, config.img_dim)
    # a float64 model decodes float32 maps (JAX's sigmoid cast): the sums
    # below promote them to float64, as jnp's do
    base, diffs = decoded[0], decoded[1:]                         # (B,D), (C,B,D)

    # --- gain (beta) distributions per covariate, over the global batch ----
    gp_p = params["gp"]
    xq = covariates.T                                             # (C, B)
    sa, std = gp_p["sa"], torch.exp(gp_p["logstd"])
    lin_kl = torch.sum(normal_kl(sa, std, 1.0, 0.5))
    beta_mean = sa[:, None] * xq                                  # (C, B)
    eye_b = torch.eye(b_all, dtype=xq.dtype, device=xq.device)
    beta_cov = eye_b[None] * (std[:, None] ** 2 * xq ** 2)[:, None, :]  # (C,B,B)

    # sparse GP for the 6 motion covariates, one batched evaluation
    kvar, ls = gp_transforms(gp_p, config)
    qu_S = resolve_qu_S(gp_p, tp)
    f_bar, sigma = gp_mod.evaluate_posterior(
        consts["xu"], kvar, ls, gp_p["qu_m"], qu_S, xq[MOTION_SLICE], tp
    )
    m_lo, m_hi = MOTION_SLICE.start, MOTION_SLICE.stop
    beta_mean = torch.cat([beta_mean[:m_lo], beta_mean[m_lo:m_hi] + f_bar,
                           beta_mean[m_hi:]])
    beta_cov = torch.cat([beta_cov[:m_lo], beta_cov[m_lo:m_hi] + sigma,
                          beta_cov[m_hi:]])
    gp_kls = gp_mod.gp_kl(gp_p["qu_m"], qu_S)                     # (6,)
    gp_kl_loss = lin_kl + torch.sum(gp_kls)

    # batch-coupled gain sample: one batched Cholesky over (C, B, B)
    if deterministic:
        gains = beta_mean
        mvn_fallbacks = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        gains, mvn_fallbacks = mvn_sample_safe(
            eps_beta, beta_mean, beta_cov + 1e-5 * eye_b[None], tpu_products=tp
        )

    # HRF-convolve neural covariates over the batch axis (reference quirk)
    if config.neural_covariates and config.num_neural > 0:
        nn_ = config.num_neural
        gains = torch.cat([hrf_convolve(gains[:nn_], consts["hrf"], tp), gains[nn_:]])
    gains_absmax = torch.max(torch.abs(gains))
    if tp and mesh is not None:
        # the TPU arm's backward products upstream round one cotangent,
        # the global batch's, not this rank's share of it
        gains = mean_cotangent(gains, mesh)
    gains = gains[:, lo:hi]                                       # this rank's columns

    # --- compose reconstruction -------------------------------------------
    x_rec = base + op.einsum("cb,cbd->bd", gains, diffs.to(gains.dtype))

    # --- GLM regularizer (closed form of sum(cdist(cons, tile(glm, B)))) ---
    if consts["glm_maps"] is not None:
        glm = consts["glm_maps"][:, 1: n_cov + 1].T               # (C, D)
        d2 = torch.sum(diffs * diffs, dim=-1)                     # (C, B)
        dg = op.einsum("cbd,cd->cb", diffs.to(glm.dtype), glm)    # (C, B)
        g2 = torch.sum(glm * glm, dim=-1)                         # (C,)
        sq = gains ** 2 * d2 - 2.0 * gains * dg + g2[:, None]
        glm_reg = b_all * torch.sum(torch.sqrt(torch.clamp(sq, min=0.0)))
    else:
        glm_reg = torch.zeros((), dtype=x.dtype, device=x.device)

    # --- ELBO ----------------------------------------------------------------
    kl_z = lowrank_mvn_kl_to_std_normal(mu, u, d)                 # (B,)
    # epsilon is read in the batch's dtype: a float64 epsilon (x64_epsilon) as
    # float32 in a float32 model, as the reference does
    obs_scale = torch.exp(-params["epsilon"].to(x.dtype)).reshape(-1)  # (D,)
    log_prob = torch.sum(
        normal_log_prob(x.reshape(b, -1), x_rec, obs_scale[None, :]), dim=-1
    )
    if mesh is None:
        elbo = torch.mean(-kl_z + log_prob)
        tot_loss = (
            -elbo + config.gp_kl_scale * gp_kl_loss + config.glm_reg_scale * glm_reg
        )
        kl_z_mean, log_prob_mean = torch.mean(kl_z), torch.mean(log_prob)
    else:
        elbo_share = torch.sum(-kl_z + log_prob) / b_all
        share = (-elbo_share + config.gp_kl_scale * gp_kl_loss / mesh.world
                 + config.glm_reg_scale * glm_reg)
        sums = all_reduce_total(torch.stack([
            elbo_share, glm_reg.to(elbo_share.dtype), kl_z.sum(), log_prob.sum()]), mesh)
        elbo, glm_reg = sums[0], sums[1]
        kl_z_mean, log_prob_mean = sums[2] / b_all, sums[3] / b_all
        tot_loss = global_value(share, -elbo + config.gp_kl_scale * gp_kl_loss
                                + config.glm_reg_scale * glm_reg)

    aux: Dict[str, Any] = {
        "elbo": elbo,
        "gp_kl": gp_kl_loss,
        "glm_reg": glm_reg,
        "beta_mean": beta_mean,
        "beta_cov_diag": torch.diagonal(beta_cov, dim1=-2, dim2=-1),
        "kl_z_mean": kl_z_mean,
        "log_prob_mean": log_prob_mean,
        "gains_absmax": gains_absmax,
        "mvn_fallbacks": mvn_fallbacks,
    }
    if return_maps:
        aux["z"] = z
        cons = gains[:, :, None] * diffs                          # (C, B, D)
        maps = {"base": base, "full_rec": x_rec}
        for j, mkey in enumerate(MAP_KEYS[1:-1]):                 # task..sex
            maps[mkey] = cons[j]
        aux["maps"] = maps
    return tot_loss, aux
