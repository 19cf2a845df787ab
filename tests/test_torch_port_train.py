"""The port's train step (vaegam_tpu_torch.train) against optax, and its
device-resident loader against the JAX one.

The optimizer is ``optax.apply_if_finite(chain(clip_by_global_norm?,
adam(1e-3)))`` on the JAX side and the Trainer's hand-written update on the
port side.  The model trajectory runs both sides in float64 (see
tests/torch_port_common.py for why JAX-CPU fp32 is too coarse a reference
for a tight comparison).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vaegam_tpu.data.device_cache import DeviceResidentLoader as JaxLoader
from vaegam_tpu.models import forward as jax_forward

from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import params_from_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_port_common import (
    THIN, XU_RANGES, f64_jax, f64_port, jax_float64, jax_noise, make_batch,
    make_model, to_np, torch_tensors,
)


def _tx(clip):
    tx = optax.adam(1e-3)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    return optax.apply_if_finite(tx, max_consecutive_errors=100000)


def _adam_state(state):
    """The ScaleByAdamState inside an apply_if_finite(...) state."""
    found = [s for s in jax.tree_util.tree_leaves(
        state.inner_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    return found[0]


def _assert_tree_close(port_tree, jax_tree, rtol, atol_frac, what):
    """Leafwise, atol = atol_frac * the leaf's largest entry (floor 1e-12)."""
    for (path, t), (_, j) in zip(tree_items(port_tree), tree_items(jax_tree)):
        j = np.asarray(j, np.float64)
        np.testing.assert_allclose(t.detach().double().numpy(), j, rtol=rtol,
                                   atol=max(1e-12, atol_frac * np.abs(j).max()),
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["adam", "clip"])
def test_optimizer_matches_optax(clip):
    """Six updates on a small tree, one with a NaN gradient: params, both
    moments, the step count and apply_if_finite's three counters track optax.  fp32
    elementwise arithmetic in the same order: rtol 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}
    params_np = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    trainer = Trainer(VAEGAMConfig(**THIN), device="cpu", grad_clip=clip,
                      params=tree_map(torch.tensor, params_np))
    tx = _tx(clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    state = tx.init(jparams)
    for step in range(6):
        grads_np = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params_np)
        if step == 3:
            grads_np["b"]["c"][2] = np.nan
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads_np),
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        trainer._apply_gradients([torch.tensor(g) for _, g in tree_items(grads_np)])
        adam = _adam_state(state)
        _assert_tree_close(trainer.params, to_np(jparams), 1e-6, 1e-7, "param")
        _assert_tree_close(trainer.opt_state["mu"], to_np(adam.mu), 1e-6, 1e-7, "mu")
        _assert_tree_close(trainer.opt_state["nu"], to_np(adam.nu), 1e-6, 1e-7, "nu")
        assert int(trainer.opt_state["count"]) == int(adam.count)
        for k in ("notfinite_count", "last_finite", "total_notfinite"):
            assert int(trainer.opt_state[k]) == int(getattr(state, k)), k
    assert int(state.total_notfinite) == 1 and int(adam.count) == 5


def test_five_train_steps_track_optax_trajectory():
    """Thin model, B=4, noise from a shared JAX key chain: 5 steps of
    value_and_grad + apply_if_finite(adam(1e-3)) against Trainer.train_step,
    both in float64.  Losses rtol 1e-8; parameters, which params_from_jax
    hands back in fp32, and Adam moments rtol 1e-6 with atol 1e-6 of each
    leaf's largest entry."""
    jc, pc, params, consts, tp, tc = make_model(THIN)
    covs, x = make_batch(jc.img_shape, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 5)
    tx = _tx(0.0)
    trainer = Trainer(pc, device="cpu", params=f64_port(tp), consts=f64_port(tc))
    with jax_float64():
        jparams, jconsts = f64_jax(params), f64_jax(consts)
        state = tx.init(jparams)
        jcovs, jx = jnp.asarray(covs, jnp.float64), jnp.asarray(x, jnp.float64)
        tcovs, tx_ = torch_tensors(covs, x, dtype=torch.float64)
        for key in keys:
            (jl, _), g = jax.value_and_grad(jax_forward, has_aux=True)(
                jparams, jconsts, key, jcovs, jx, jc)
            updates, state = tx.update(g, state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            noise = torch_tensors(*jax_noise(key, 4, jc.num_latents), dtype=torch.float64)
            tl, _ = trainer.train_step(tcovs, tx_, noise=noise)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-8)
        adam = _adam_state(state)
        want_p, _ = params_from_jax(to_np(jparams), None, pc)
        want_mu, _ = params_from_jax(to_np(adam.mu), None, pc)
        want_nu, _ = params_from_jax(to_np(adam.nu), None, pc)
    _assert_tree_close(trainer.params, tree_map(lambda t: t.numpy(), want_p),
                       1e-6, 1e-6, "param")
    _assert_tree_close(trainer.opt_state["mu"], tree_map(lambda t: t.numpy(), want_mu),
                       1e-6, 1e-6, "mu")
    _assert_tree_close(trainer.opt_state["nu"], tree_map(lambda t: t.numpy(), want_nu),
                       1e-6, 1e-6, "nu")
    assert int(trainer.opt_state["count"]) == int(adam.count) == 5


def test_nonfinite_step_is_skipped_and_counted_on_both_sides():
    """A qu_S with a negative diagonal makes gp_kl (and the loss) NaN: both
    sides skip the update, leave params and moments untouched and count it."""
    jc, pc, params, consts, tp, tc = make_model(THIN)
    params["gp"]["qu_S"] = params["gp"]["qu_S"].at[0, 0, 0].set(-1.0)
    tp["gp"]["qu_S"][0, 0, 0] = -1.0
    covs, x = make_batch(jc.img_shape, 4)
    key = jax.random.PRNGKey(9)

    tx = _tx(0.0)
    state = tx.init(params)
    (jl, _), g = jax.value_and_grad(jax_forward, has_aux=True)(
        params, consts, key, jnp.asarray(covs), jnp.asarray(x), jc)
    updates, state = tx.update(g, state, params)
    new = optax.apply_updates(params, updates)
    assert not np.isfinite(float(jl)) and int(state.total_notfinite) == 1
    for a, b in zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    trainer = Trainer(pc, device="cpu", params=tp, consts=tc)
    before = tree_map(lambda t: t.detach().clone(), trainer.params)
    tl, _ = trainer.train_step(*torch_tensors(covs, x),
                               noise=torch_tensors(*jax_noise(key, 4, jc.num_latents)))
    assert not np.isfinite(float(tl))
    assert int(trainer.opt_state["total_notfinite"]) == 1
    assert int(trainer.opt_state["count"]) == 0
    for (path, a), (_, b) in zip(tree_items(trainer.params), tree_items(before)):
        assert torch.equal(a.detach(), b), path
    for _, m in tree_items(trainer.opt_state["mu"]) + tree_items(trainer.opt_state["nu"]):
        assert float(m.abs().max()) == 0.0


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_batch_order_matches_jax(drop_last):
    rng = np.random.default_rng(3)
    vols = rng.uniform(size=(11, 3, 4, 5)).astype(np.float32)
    covs = rng.normal(size=(11, 8)).astype(np.float32)
    kw = dict(batch_size=3, shuffle=True, seed=4, drop_last=drop_last)
    ours = DeviceResidentLoader.from_arrays(vols, covs, device="cpu", **kw)
    ref = JaxLoader.from_arrays(vols, covs, **kw)
    assert len(ours) == len(ref) and ours.num_samples == ref.num_samples == 11
    for epoch in (0, 1, 5):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours.iter_index_batches()), list(ref.iter_index_batches())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        c, v = ours.gather(got[0])
        np.testing.assert_array_equal(v.numpy(), vols[want[0]])
        np.testing.assert_array_equal(c.numpy(), covs[want[0]])


def test_train_epoch_on_device_resident_loader():
    """One epoch over 8 volumes at batch 4: finite loss normalized by the
    sample count, the epoch advanced and timed, fallbacks counted."""
    pc = VAEGAMConfig(**THIN)
    rng = np.random.default_rng(6)
    glm = rng.normal(size=(pc.img_dim, 9)).astype(np.float32)
    trainer = Trainer(pc, XU_RANGES, glm, device="cpu", seed=2)
    covs, vols = make_batch(pc.img_shape, 8, seed=7)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, shuffle=True,
                                              seed=1, device="cpu")
    start = [t.detach().clone() for _, t in tree_items(trainer.params)]
    loss = trainer.train_epoch(loader)
    assert np.isfinite(loss)
    assert trainer.epoch == 1 and trainer.epoch_seconds[0] > 0
    assert isinstance(trainer.mvn_fallbacks, int)
    assert int(trainer.opt_state["count"]) == 2
    moved = [not torch.equal(a, b) for a, (_, b) in zip(start, tree_items(trainer.params))]
    assert np.mean(moved) > 0.9


def test_trainer_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(VAEGAMConfig(**THIN), XU_RANGES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceResidentLoader.from_arrays(np.zeros((2, 3, 3, 3)), np.zeros((2, 8)))


def test_x64_epsilon_adam_steps_match_jax():
    """x64_epsilon on the thin model: epsilon is float64 and every other leaf
    fp32 on both sides (JAX under enable_x64), 3 steps of value_and_grad +
    apply_if_finite(adam(1e-3)) against Trainer.train_step with JAX's noise.
    Losses at rtol 1e-4 (fp32 forwards); epsilon and both of its Adam moments
    stay float64, epsilon within 1e-8 of JAX's (measured 2.0e-9 after
    ~3e-3 of movement) and the moments within rtol 1e-4: its gradient,
    1 - (x - x_rec)^2 exp(2 eps) per voxel, is ~1 at the initial
    eps = -log 10, so the fp32 rounding of the forward moves it by ~1e-7
    relative and Adam's normalized step by less."""
    kw = dict(THIN, x64_epsilon=True)
    covs, x = make_batch(THIN["img_shape"], 4)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    noises = [torch_tensors(*jax_noise(k, 4, THIN["num_latents"])) for k in keys]
    tx = _tx(0.0)
    with jax.enable_x64(True):
        jc, pc, params, consts, tp, tc = make_model(kw)
        assert params["epsilon"].dtype == jnp.float64
        trainer = Trainer(pc, device="cpu", params=tp, consts=tc)
        state = tx.init(params)
        for key, noise in zip(keys, noises):
            (jl, _), g = jax.value_and_grad(jax_forward, has_aux=True)(
                params, consts, key, jnp.asarray(covs), jnp.asarray(x), jc)
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
            tl, _ = trainer.train_step(*torch_tensors(covs, x), noise=noise)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        adam = _adam_state(state)
        want = {k: np.asarray(v["epsilon"]) for k, v in
                (("param", params), ("mu", adam.mu), ("nu", adam.nu))}
    got = {"param": trainer.params["epsilon"], "mu": trainer.opt_state["mu"]["epsilon"],
           "nu": trainer.opt_state["nu"]["epsilon"]}
    for k, t in got.items():
        assert t.dtype == torch.float64 and want[k].dtype == np.float64, k
    assert trainer.params["enc"]["conv1"]["w"].dtype == torch.float32
    np.testing.assert_allclose(got["param"].detach().numpy(), want["param"], rtol=0, atol=1e-8)
    for k in ("mu", "nu"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, err_msg=k)
    assert float((got["param"] + np.log(10.0)).abs().min()) > 2e-3   # it moved

