"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_port_*.py).

Both packages get the same weights (JAX ``init_model`` carried over with
``params_from_jax``), the same inputs (numpy, from a seed) and the same noise
(drawn with JAX's own key chain, vaegam.py:305,318-320 and
distributions.py:99).

Precision.  JAX's CPU backend sums an fp32 reduction sequentially: its
batch-stat variances over the decoder's ~1e5-element groups carry up to
~1.5e-3 relative error (measured against float64 on the thin model's bnt5
input), and the ELBO's gradient wrt the encoder cancels over the whole
volume, so JAX-CPU fp32 maps sit 1e-4..3e-3 and its encoder gradients up to
~15% away from a float64 evaluation, while the port's fp32 (pairwise-summed)
stays within ~1e-5.  The tight parity checks therefore run both sides in
float64: JAX under ``jax.enable_x64`` with the package's own code, except
that the two fp32 casts in its networks module (the norm statistics and the
decoder output) become float64 casts (:func:`jax_float64`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vaegam_tpu.models import VAEGAMConfig as JaxConfig, init_model as jax_init
import vaegam_tpu.models.networks as jax_networks

from vaegam_tpu_torch.models import VAEGAMConfig as PortConfig
from vaegam_tpu_torch.utils.jax_params import params_from_jax

THIN = dict(nf=2, num_latents=8, img_shape=(21, 25, 21))
# the smallest grid whose encoder floors and decoder crop (2 on D) are the
# MNI152 2 mm grid's, 91x109x91, on every axis (test_torch_port_mni_grid.py)
MNI_ROUNDING = (23, 21, 23)
FULL = dict()
# wide inducing grid: well-separated inducing points keep Kuu well
# conditioned (tests/test_reference_parity.py:41-48)
XU_RANGES = [[-20.0, 20.0]] * 6


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_model(cfg_kw, seed=0, glm=True):
    """(jax_config, port_config, jax params, jax consts, port params, port consts)."""
    jc, pc = JaxConfig(**cfg_kw), PortConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    glm_maps = (rng.normal(size=(jc.img_dim, jc.num_covariates + 1))
                .astype(np.float32) if glm else None)
    params, consts = jax_init(jax.random.PRNGKey(seed), jc, XU_RANGES, glm_maps)
    tp, tc = params_from_jax(to_np(params), to_np(consts), pc, "cpu")
    return jc, pc, params, consts, tp, tc


def make_batch(img_shape, batch, seed=1, n_cov=8):
    rng = np.random.default_rng(seed)
    covs = rng.normal(size=(batch, n_cov)).astype(np.float32)
    covs[:, 0] = (rng.uniform(size=batch) > 0.5).astype(np.float32)
    x = rng.uniform(0, 1, size=(batch,) + tuple(img_shape)).astype(np.float32)
    return covs, x


def jax_noise(key, batch, num_latents, n_cov=8):
    """The three draws of vaegam.forward for `key`, as numpy arrays."""
    k_z, k_beta = jax.random.split(key)
    k_w, k_d = jax.random.split(k_z)
    return (np.asarray(jax.random.normal(k_w, (batch, 1))),
            np.asarray(jax.random.normal(k_d, (batch, num_latents))),
            np.asarray(jax.random.normal(k_beta, (n_cov, batch))))


class _JnpFloat32AsFloat64:
    """jax.numpy, except that ``float32`` names float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """JAX in float64, with the networks module's fp32 casts (norm
    statistics, decoder output) lifted to float64; restored afterwards."""
    orig = jax_networks.jnp
    jax_networks.jnp = _JnpFloat32AsFloat64()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jax_networks.jnp = orig


def f64_jax(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else jnp.asarray(np.asarray(a, np.float64)),
        tree)


def f64_port(tree):
    return {k: (f64_port(v) if isinstance(v, dict) else
                None if v is None else v.double())
            for k, v in tree.items()}


def torch_tensors(*arrays, dtype=torch.float32):
    return tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in arrays)
