"""Parity of the port's model math (vaegam_tpu_torch.models) with the JAX package.

Inputs come from numpy seeds; weights from JAX ``init_model`` through
``params_from_jax``; noise from JAX's key chain.  The port always runs with
device="cpu" (the conv5 op then takes its plain version).  See
tests/torch_port_common.py for why the tight checks run in float64.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from vaegam_tpu.models import VAEGAMConfig as JaxConfig, init_model as jax_init
from vaegam_tpu.models import forward as jax_forward
from vaegam_tpu.train import Trainer as JaxTrainer
from vaegam_tpu.models import distributions as jdist
from vaegam_tpu.models import gp as jgp
from vaegam_tpu.models.networks import _batch_stat_norm as jax_bsn
from vaegam_tpu.models.vaegam import _hrf_convolve as jax_hrf_convolve
from vaegam_tpu.models.vaegam import hrf_kernel as jax_hrf_kernel
from vaegam_tpu.models.vaegam import resolve_qu_S as jax_resolve_qu_S
from vaegam_tpu.utils.torch_export import export_layer_state

from vaegam_tpu_torch.models import distributions as tdist
from vaegam_tpu_torch.models import gp as tgp
from vaegam_tpu_torch.models import MAP_KEYS, VAEGAMConfig, forward, init_model
from vaegam_tpu_torch.models.networks import batch_stat_norm
from vaegam_tpu_torch.models.vaegam import hrf_convolve, hrf_kernel, resolve_qu_S
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import params_from_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_port_common import (
    FULL, MNI_ROUNDING, THIN, f64_jax, f64_port, jax_float64, jax_noise, make_batch,
    make_model, to_np, torch_tensors,
)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_hrf_kernel_matches_jax():
    np.testing.assert_array_equal(hrf_kernel().numpy(), np.asarray(jax_hrf_kernel()))
    assert hrf_kernel().shape == (15,)


@pytest.mark.parametrize("batch", [2, 32])
def test_hrf_batch_axis_convolution_matches_jax(batch):
    """The HRF runs over the BATCH axis; B=2 is shorter than the 15 taps.
    fp32 sums of <=15 products: atol 1e-6."""
    rng = np.random.default_rng(batch)
    gains = rng.normal(size=(2, batch)).astype(np.float32)
    kern = np.asarray(jax_hrf_kernel())
    want = np.stack([np.asarray(jax_hrf_convolve(jnp.asarray(g), jnp.asarray(kern)))
                     for g in gains])
    got = hrf_convolve(torch.tensor(gains), torch.tensor(kern)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _non_psd_stack():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 5))
    good = a @ a.T + 5 * np.eye(5)
    bad = good.copy()
    bad[0, 1] = bad[1, 0] = 40.0               # indefinite even with jitter
    near = good - (np.linalg.eigvalsh(good)[0] + 5e-4) * np.eye(5)  # rescued by 1e-3
    return np.stack([good, bad, near]).astype(np.float32)


def test_cholesky_nan_matches_jax_semantics():
    """NaN lower triangle / zeros above on failure; NaN gradient for exactly
    the failed matrix, as jnp.linalg.cholesky gives.  Float64: atol 1e-10."""
    cov = _non_psd_stack().astype(np.float64)
    w = np.random.default_rng(4).normal(size=cov.shape)
    with jax.enable_x64(True):
        jl = np.asarray(jnp.linalg.cholesky(jnp.asarray(cov)))
        jg = np.asarray(jax.grad(
            lambda c: jnp.nansum(jnp.linalg.cholesky(c) * w))(jnp.asarray(cov)))
    t = torch.tensor(cov, requires_grad=True)
    tl = tdist.cholesky_nan(t)
    torch.nansum(tl * torch.tensor(w)).backward()
    np.testing.assert_array_equal(np.isnan(tl.detach().numpy()), np.isnan(jl))
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-10)
    np.testing.assert_array_equal(np.isnan(t.grad.numpy()), np.isnan(jg))
    np.testing.assert_allclose(t.grad.numpy(), jg, atol=1e-10)


def test_mvn_sample_safe_non_psd_stack():
    """Same samples and the same fallback count on a crafted non-PSD stack.
    fp32 Cholesky of 5x5 matrices: atol 1e-5."""
    cov = _non_psd_stack()
    mean = np.random.default_rng(5).normal(size=cov.shape[:2]).astype(np.float32)
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, mean.shape))
    jout, jcount = jdist.mvn_sample_safe(key, jnp.asarray(mean), jnp.asarray(cov),
                                         return_fallback_count=True)
    tout, tcount = tdist.mvn_sample_safe(*torch_tensors(eps, mean, cov))
    assert int(tcount) == int(jcount) == 2
    jout = np.asarray(jout)
    np.testing.assert_array_equal(np.isnan(tout.numpy()), np.isnan(jout))
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)


def test_gp_kl_nan_on_non_psd_qu_S():
    rng = np.random.default_rng(7)
    qu_m = rng.normal(size=(2, 6)).astype(np.float32)
    qu_S = np.stack([2 * np.eye(6), 2 * np.eye(6)]).astype(np.float32)
    qu_S[1, 2, 2] = -1.0
    want = np.asarray(jax.vmap(jgp.gp_kl)(jnp.asarray(qu_m), jnp.asarray(qu_S)))
    got = tgp.gp_kl(*torch_tensors(qu_m, qu_S)).numpy()
    assert np.isnan(want[1]) and np.isnan(got[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_evaluate_posterior_matches_jax_at_narrow_inducing_grid():
    """xu over [-2,2] at the initial ls (~2.45): Kuu's condition number is
    ~1e8, so fp32 solves on two backends legitimately diverge; both sides
    run in float64, where the LU solve keeps ~8 digits: rtol 1e-6."""
    rng = np.random.default_rng(8)
    g, p, b = 6, 6, 12
    xu = np.tile(np.linspace(-2.0, 2.0, p), (g, 1))
    kvar = np.exp(rng.normal(size=g) * 0.1) + 0.1
    ls = 3.0 / (1 + np.exp(-(np.exp(rng.normal(size=g) * 0.1) + 0.5)))
    qu_m = rng.normal(size=(g, p))
    a = rng.normal(size=(g, p, p))
    qu_S = a @ a.transpose(0, 2, 1) + 2 * np.eye(p)
    xq = rng.uniform(-2, 2, size=(g, b))
    with jax.enable_x64(True):
        jf, js = jax.vmap(jgp.evaluate_posterior)(*(jnp.asarray(v) for v in (
            xu, kvar, ls, qu_m, qu_S, xq)))
        jf, js = np.asarray(jf), np.asarray(js)
    tf, ts = tgp.evaluate_posterior(*torch_tensors(xu, kvar, ls, qu_m, qu_S, xq,
                                                   dtype=torch.float64))
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=1e-8)


def test_singular_kuu_gives_nonfinite_values_on_both_sides():
    """Every inducing point of one GP at the same place makes its Kuu
    exactly singular (rank 1).  JAX's unguarded LU solve returns
    non-finite values there and raises nothing; so does the port's
    (``solve_ex``, no error check), in both posterior functions, while the
    other GPs stay finite.  A train step on such consts is then skipped
    and counted on both sides, parameters and moments untouched."""
    import optax

    rng = np.random.default_rng(9)
    g, p, b = 6, 6, 5
    xu = np.tile(np.linspace(-2.0, 2.0, p), (g, 1)).astype(np.float32)
    xu[2] = 0.5
    kvar = (np.exp(rng.normal(size=g) * 0.1) + 0.1).astype(np.float32)
    ls = (3.0 / (1 + np.exp(-(np.exp(rng.normal(size=g) * 0.1) + 0.5)))).astype(np.float32)
    qu_m = rng.normal(size=(g, p)).astype(np.float32)
    qu_S = np.tile(2 * np.eye(p, dtype=np.float32), (g, 1, 1))
    xq = rng.uniform(-2, 2, size=(g, b)).astype(np.float32)
    args = (xu, kvar, ls, qu_m, qu_S, xq)
    for jfn, tfn in ((jgp.evaluate_posterior, tgp.evaluate_posterior),
                     (jgp.evaluate_posterior_diag, tgp.evaluate_posterior_diag)):
        want = [np.asarray(v) for v in jax.vmap(jfn)(*(jnp.asarray(v) for v in args))]
        got = [v.numpy() for v in tfn(*torch_tensors(*args))]
        for w, t in zip(want, got):
            assert not np.isfinite(w[2]).all() and not np.isfinite(t[2]).all()
            assert np.isfinite(np.delete(w, 2, axis=0)).all()
            assert np.isfinite(np.delete(t, 2, axis=0)).all()

    jc, pc, params, consts, tp, tc = make_model(THIN)
    consts = dict(consts, xu=consts["xu"].at[2].set(0.5))
    tc["xu"][2] = 0.5
    covs, x = make_batch(jc.img_shape, 4)
    key = jax.random.PRNGKey(9)
    tx = optax.apply_if_finite(optax.adam(1e-3), max_consecutive_errors=100000)
    state = tx.init(params)
    (jl, _), grads = jax.jit(jax.value_and_grad(jax_forward, has_aux=True),
                             static_argnums=5)(params, consts, key, jnp.asarray(covs),
                                               jnp.asarray(x), jc)
    updates, state = tx.update(grads, state, params)
    new = optax.apply_updates(params, updates)
    assert not np.isfinite(float(jl)) and int(state.total_notfinite) == 1
    for a, c in zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

    trainer = Trainer(pc, device="cpu", params=tp, consts=tc)
    before = tree_map(lambda t: t.detach().clone(), trainer.params)
    loss, _ = trainer.train_step(*torch_tensors(covs, x),
                                 noise=torch_tensors(*jax_noise(key, 4, jc.num_latents)))
    assert not np.isfinite(float(loss))
    assert int(trainer.opt_state["total_notfinite"]) == 1
    assert int(trainer.opt_state["count"]) == 0
    for (path, a), (_, c) in zip(tree_items(trainer.params), tree_items(before)):
        assert torch.equal(a.detach(), c), path
    for _, m in tree_items(trainer.opt_state["mu"]) + tree_items(trainer.opt_state["nu"]):
        assert float(m.abs().max()) == 0.0


@pytest.mark.parametrize("groups", [1, 9])
def test_batch_stat_norm_groups_matches_jax(groups):
    """Per-contiguous-group statistics; 18 rows x 4 ch x 5x6x4 (480-element
    sums per group): fp32 atol 1e-5."""
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(18, 5, 6, 4, 4)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=4).astype(np.float32),
         "shift": rng.normal(size=4).astype(np.float32)}
    want = np.asarray(jax_bsn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                              groups))
    got = batch_stat_norm(torch.tensor(x.transpose(0, 4, 1, 2, 3).copy()),
                          {k: torch.tensor(v) for k, v in p.items()}, groups)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want, atol=1e-5)


# ---------------------------------------------------------------------------
# weights, config, init
# ---------------------------------------------------------------------------

def test_params_from_jax_matches_reference_export():
    """The port's layer weights equal the JAX package's tested export to the
    reference torch layout (utils/torch_export.py), bit for bit."""
    jc, pc, params, _, tp, _ = make_model(THIN, glm=False)
    ref = export_layer_state(to_np(params), jc.nf)
    for net in ("enc", "dec"):
        for name, p in tp[net].items():
            r = ref[name]
            if name.startswith("bn"):
                np.testing.assert_array_equal(p["scale"].numpy(), r["weight"])
                np.testing.assert_array_equal(p["shift"].numpy(), r["bias"])
            else:
                np.testing.assert_array_equal(p["w"].numpy(), r["weight"])
                np.testing.assert_array_equal(p["b"].numpy(), r["bias"])


def test_init_model_structure_matches_jax():
    """init_model(key=k) is the JAX package's init_model(k) in the port's
    layout: every uniform-drawn weight and every constant bit for bit, the
    normal-drawn sa, logstd and qu_m within 3 ulps (rtol 1e-6: JAX's
    float32 erfinv reads log1p a bit off numpy's now and then); the
    inducing grids within 1e-6.  Thin model here; the Cholesky
    parameterization and the reference grid below."""
    _check_init_matches_jax(THIN)


@pytest.mark.parametrize("cfg_kw", [dict(THIN, qu_s_cholesky=True), FULL],
                         ids=["thin-cholesky", "full"])
def test_init_model_matches_jax(cfg_kw):
    _check_init_matches_jax(cfg_kw)


def _check_init_matches_jax(cfg_kw):
    jc, pc = JaxConfig(**cfg_kw), VAEGAMConfig(**cfg_kw)
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    params, consts = jax_init(key, jc, [[-2.0, 2.0]] * 6)
    want, _ = params_from_jax(to_np(params), None, pc, "cpu")
    own, own_c = init_model(pc, [[-2.0, 2.0]] * 6, np.zeros((pc.img_dim, 9)),
                            key=np.asarray(key), device="cpu")
    assert [(k, tuple(v.shape), v.dtype) for k, v in tree_items(own)] == \
        [(k, tuple(v.shape), v.dtype) for k, v in tree_items(want)]
    for path, a in tree_items(own):
        b = dict(tree_items(want))[path]
        if path in ("gp/sa", "gp/logstd", "gp/qu_m"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=path)
        else:
            assert torch.equal(a, b), path
    np.testing.assert_allclose(own_c["xu"].numpy(), np.asarray(consts["xu"]), atol=1e-6)
    # torch-default bound U(+-1/sqrt(fan_in)): conv1 fan_in = 27
    assert float(own["enc"]["conv1"]["w"].abs().max()) <= 1 / np.sqrt(27)


def test_trainer_init_matches_jax_trainer():
    """A seed gives the port's Trainer the JAX Trainer's initial weights
    (its init key is the second half of PRNGKey(seed)'s split)."""
    xu = [[-2.0, 2.0]] * 6
    jt = JaxTrainer(JaxConfig(**THIN), xu, enable_tb=False, seed=5)
    t = Trainer(VAEGAMConfig(**THIN), xu, device="cpu", seed=5)
    want, _ = params_from_jax(to_np(jt.params), None, t.config, "cpu")
    for (path, a), (_, b) in zip(tree_items(t.params), tree_items(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-6, atol=0,
                                   err_msg=path)


def test_qu_s_cholesky_init_matches_jax():
    """The raw factor is JAX's bit for bit (diag(0.5 log 2) for each of the
    6 motion GPs, no qu_S) and resolves to 2I: fp32 exp and product, atol
    1e-6; the port's resolve_qu_S equals JAX's on it bit for bit."""
    kw = dict(THIN, qu_s_cholesky=True)
    jc, pc, params, _, tp, _ = make_model(kw)
    own, _ = init_model(pc, [[-2.0, 2.0]] * 6, seed=3, device="cpu")
    want = np.asarray(params["gp"]["qu_S_raw"])
    assert "qu_S" not in own["gp"] and "qu_S" not in tp["gp"]
    np.testing.assert_array_equal(own["gp"]["qu_S_raw"].numpy(), want)
    np.testing.assert_array_equal(tp["gp"]["qu_S_raw"].numpy(), want)
    got = resolve_qu_S(own["gp"]).numpy()
    np.testing.assert_allclose(got, np.tile(2 * np.eye(6), (6, 1, 1)), atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(jax_resolve_qu_S(params["gp"])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qu_s_cholesky_resolves_psd(seed):
    """Any raw values give a symmetric positive-definite qu_S (float64,
    smallest eigenvalue > 0, symmetric to 1e-12) equal to JAX's (rtol
    1e-12), and its gradient reaches every lower-triangle entry."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(6, 6, 6)) * 2
    t = torch.tensor(raw, requires_grad=True)
    got = resolve_qu_S({"qu_S_raw": t})
    with jax.enable_x64(True):
        want = np.asarray(jax_resolve_qu_S({"qu_S_raw": jnp.asarray(raw)}))
    g = got.detach().numpy()
    np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g, g.transpose(0, 2, 1), atol=1e-12)
    assert np.linalg.eigvalsh(g).min() > 0
    got.sum().backward()
    lower = np.tril(np.ones((6, 6), bool))
    assert np.all(t.grad.numpy()[:, lower] != 0) and np.all(t.grad.numpy()[:, ~lower] == 0)


# ---------------------------------------------------------------------------
# bf16 recipe
# ---------------------------------------------------------------------------

BF16 = (jnp.bfloat16, torch.bfloat16)
# the correctness oracle's model flags (tools/control_experiment.py)
ORACLE_FLAGS = dict(qu_s_cholesky=True, fused_norm_stats=True, neural_covariates=False)
BF16_CASES = {
    "conv": dict(conv_dtype=BF16),
    "enc": dict(enc_conv_dtype=BF16),
    "dec": dict(dec_conv_dtype=BF16),
    "conv-fp32-final": dict(conv_dtype=BF16, dec_fp32_final=(True, True)),
}


class _ConvAndMeanDtypes(TorchFunctionMode):
    """Records (op, input dtype, weight dtype) of every conv and the dtype
    of every mean (the batch-stat-norm statistics are means)."""

    def __init__(self):
        super().__init__()
        self.convs, self.means = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("conv3d", "conv_transpose3d"):
            self.convs.append((name, args[0].dtype, args[1].dtype))
        elif name == "mean":
            self.means.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_recipe_matches_jax(case):
    """Thin model, B=4, deterministic, the same params on both sides.

    tot_loss against JAX's bf16 forward at rtol 1e-4 (measured <= 1.2e-6 on
    this input); each of the 10 maps at a relative L2 error of 1e-2 (measured
    <= 3.0e-3; the two backends round the bf16 convs differently, and the
    bf16-vs-fp32 gap itself is up to 9e-3); the port's bf16 loss within 1%
    of its own fp32 loss, as tests/test_networks.py holds JAX.  Dtypes:
    the bf16 stack's convs take bf16 activations and weights (an fp32
    convt5, under dec_fp32_final or in an fp32 stack, through the convt5
    op), no mean runs in
    bf16 (norm statistics fp32), maps and loss come out fp32.
    """
    jc, pc, params, consts, tp, tc = make_model(THIN)
    kw = BF16_CASES[case]
    jc = dataclasses.replace(jc, **{k: v[0] for k, v in kw.items()})
    pc32, pc = pc, dataclasses.replace(pc, **{k: v[1] for k, v in kw.items()})
    covs, x = make_batch(jc.img_shape, 4)
    jl, ja = jax_forward(params, consts, jax.random.PRNGKey(0), jnp.asarray(covs),
                         jnp.asarray(x), jc, deterministic=True, return_maps=True)
    log = _ConvAndMeanDtypes()
    with torch.no_grad(), log:
        tl, ta = forward(tp, tc, *torch_tensors(covs, x), pc, deterministic=True,
                         return_maps=True)
    with torch.no_grad():
        tl32, _ = forward(tp, tc, *torch_tensors(covs, x), pc32, deterministic=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in MAP_KEYS:
        got, want = ta["maps"][k].numpy(), np.asarray(ja["maps"][k])
        assert got.dtype == np.float32, k
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-6)
        assert err <= 1e-2, (k, err)
    assert abs(float(tl) - float(tl32)) < 0.01 * abs(float(tl32))
    assert tl.dtype == torch.float32

    enc_bf16 = case != "dec"
    dec_bf16 = case != "enc"
    enc = [c for c in log.convs if c[0] == "conv3d"]
    dec = [c for c in log.convs if c[0] == "conv_transpose3d"]
    want_enc = torch.bfloat16 if enc_bf16 else torch.float32
    # an fp32 conv5 runs through the conv5 op (its plain version here)
    assert len(enc) == (5 if enc_bf16 else 4)
    assert all(c[1] == c[2] == want_enc for c in enc), enc
    # an fp32 convt5 (an fp32 stack, or under dec_fp32_final) runs through
    # the convt5 op (its plain version here)
    half_convt5 = dec_bf16 and case != "conv-fp32-final"
    want_dec = [torch.bfloat16 if dec_bf16 else torch.float32] * (5 if half_convt5 else 4)
    assert [c[1] for c in dec] == [c[2] for c in dec] == want_dec, dec
    assert log.means and torch.bfloat16 not in log.means


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(VAEGAMConfig(**THIN), [[-2.0, 2.0]] * 6)


# ---------------------------------------------------------------------------
# forward parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "noise"])
@pytest.mark.parametrize("cfg_kw,batch", [(THIN, 4), (FULL, 2),
                                          (dict(THIN, **ORACLE_FLAGS), 4),
                                          (dict(THIN, img_shape=MNI_ROUNDING), 2)],
                         ids=["thin", "full", "thin-cholesky-oracle", "thin-mni-rounding"])
def test_forward_parity(cfg_kw, batch, deterministic):
    """Thin model (21x25x21 grid: exercises the decoder crop) at B=4 and the
    reference grid at B=2; deterministic and with JAX-drawn noise; the thin
    model also at the oracle's flags: the Cholesky parameterization of
    qu_S (qu_S_raw's gradient is one of the leaves), joint decoder norm
    statistics and no HRF on the task gain; and at B=2 on MNI_ROUNDING,
    the smallest grid that rounds as the MNI152 2 mm grid does.

    1. fp32, the packages as they run: tot_loss, elbo, gp_kl, glm_reg at
       rtol 1e-4.
    2. float64 on both sides (see torch_port_common): all 10 maps at atol
       1e-5, the scalars at rtol 1e-4 and the gradient of tot_loss leaf by
       leaf (JAX grads mapped through params_from_jax) at rtol 1e-3 /
       atol 1e-5.  This is the semantic check.
    3. The port's fp32 against its own float64 run: maps atol 1e-5; grads
       rtol 1e-3 with atol 2e-2 of each leaf's largest entry, floored at
       1e-4.  The decoder's batch-stat norms over B-row groups amplify fp32
       rounding in the fc8 gradient to 1.1e-2 of its largest entry (full
       grid, B=2; every other leaf stays under 2.2e-3), and a gradient that
       is zero in exact arithmetic (logkvar on the deterministic path, where
       kvar cancels out of A = Kuq^T Kuu^-1) comes out of fp32 as ~3e-5 of
       cancellation noise on a ~5e4 loss.
    """
    jc, pc, params, consts, tp, tc = make_model(cfg_kw)
    pc = dataclasses.replace(pc, conv5_kernel=True)
    covs, x = make_batch(jc.img_shape, batch)
    key = jax.random.PRNGKey(11)
    scalars = ("elbo", "gp_kl", "glm_reg")

    def port(dtype, noise):
        """Port forward + backward in `dtype`: (loss, aux, params with .grad)."""
        prm = tree_map(lambda t: t.to(dtype, copy=True).requires_grad_(True), tp)
        cst = tc if dtype == torch.float32 else f64_port(tc)
        loss, aux = forward(prm, cst, *torch_tensors(covs, x, dtype=dtype), pc,
                            noise=None if noise is None else
                            torch_tensors(*noise, dtype=dtype),
                            return_maps=True, deterministic=deterministic)
        loss.backward()
        return loss.item(), aux, prm

    # 1. fp32
    noise32 = None if deterministic else jax_noise(key, batch, jc.num_latents)
    jl, ja = jax_forward(params, consts, key, jnp.asarray(covs), jnp.asarray(x), jc,
                         deterministic=deterministic)
    tl, ta, tp32 = port(torch.float32, noise32)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-4)
    for k in scalars:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-4)

    # 2. float64 on both sides (under x64 JAX draws its noise in float64)
    with jax_float64():
        noise64 = None if deterministic else jax_noise(key, batch, jc.num_latents)
        (jl64, ja64), jg64 = jax.value_and_grad(jax_forward, has_aux=True)(
            f64_jax(params), f64_jax(consts), key, jnp.asarray(covs, jnp.float64),
            jnp.asarray(x, jnp.float64), jc, return_maps=True,
            deterministic=deterministic)
        jl64, ja64, jg64 = float(jl64), to_np(ja64), to_np(jg64)
    tl64, ta64, tp64 = port(torch.float64, noise64)
    np.testing.assert_allclose(tl64, jl64, rtol=1e-4)
    for k in scalars:
        np.testing.assert_allclose(float(ta64[k]), float(ja64[k]), rtol=1e-4)
    assert set(ta64["maps"]) == set(MAP_KEYS)
    for k in MAP_KEYS:
        np.testing.assert_allclose(ta64["maps"][k].detach().numpy(),
                                   ja64["maps"][k], atol=1e-5, err_msg=k)
    jgrads, _ = params_from_jax(jg64, None, pc, "cpu")
    for (path, jg), (_, p64) in zip(tree_items(jgrads), tree_items(tp64)):
        want = p64.grad.numpy()
        np.testing.assert_allclose(want, jg.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=path)

    # 3. the port's fp32 against its float64 run on the same (fp32) noise
    _, ref_a, ref_p = (ta64, ta64, tp64) if deterministic else \
        port(torch.float64, noise32)
    for k in MAP_KEYS:
        np.testing.assert_allclose(ta["maps"][k].detach().numpy(),
                                   ref_a["maps"][k].detach().numpy(), atol=1e-5,
                                   err_msg=k)
    for (path, p32), (_, p64) in zip(tree_items(tp32), tree_items(ref_p)):
        want = p64.grad.numpy()
        np.testing.assert_allclose(p32.grad.double().numpy(), want, rtol=1e-3,
                                   atol=max(1e-4, 2e-2 * np.abs(want).max()),
                                   err_msg=path)
