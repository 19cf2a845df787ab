"""float64 models: the port's ``VAEGAMConfig(dtype=torch.float64)`` against
the JAX package's ``dtype=jnp.float64`` under ``jax.enable_x64``.

JAX's float64 is partial: the norm statistics and the decoder's sigmoid run
in float32 (vaegam_tpu/models/networks.py:184-189,333), and the port does the
same.  Those float32 statistics are where the two packages part: JAX's CPU
backend sums a float32 reduction sequentially (see torch_port_common), so its
statistics over the decoder's ~1e5-element groups are off by up to ~1e-3,
torch's (pairwise) by ~1e-7.  The tight checks therefore also run JAX with
its float32 statistics summed in float64 and rounded to float32
(:func:`jax_precise_f32_stats`): the same dtypes and casts, a better sum.
No float64 lift here: both sides run their float64 semantics as they are.
All on the thin model (nf=2, 8 latents, 21x25x21) on the CPU.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vaegam_tpu.models.networks as jax_networks
from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.data import setup_data_loaders as jax_loaders
from vaegam_tpu.models import VAEGAMConfig as JaxConfig, forward as jax_forward
from vaegam_tpu.models import init_model as jax_init
from vaegam_tpu.train import Trainer as JaxTrainer

from vaegam_tpu_torch.data import DeviceResidentLoader, setup_data_loaders
from vaegam_tpu_torch.models import MAP_KEYS, VAEGAMConfig, forward, init_model
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import params_from_jax, params_to_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_port_common import THIN, XU_RANGES, jax_noise, make_batch, to_np

F64 = dict(THIN, dtype=jnp.float64)
ORACLE_FLAGS = dict(qu_s_cholesky=True, fused_norm_stats=True, neural_covariates=False)


def port_config(**kw):
    return VAEGAMConfig(**dict(THIN, dtype=torch.float64, conv5_kernel=False, **kw))


class _PreciseStats:
    """jax.numpy, except that mean and var of a float32 array are summed in
    float64 and rounded back to float32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def mean(x, axis=None, keepdims=False):
        return jnp.mean(x.astype(jnp.float64), axis=axis, keepdims=keepdims).astype(x.dtype)

    @staticmethod
    def var(x, axis=None, keepdims=False):
        return jnp.var(x.astype(jnp.float64), axis=axis, keepdims=keepdims).astype(x.dtype)


@contextlib.contextmanager
def jax_precise_f32_stats():
    orig = jax_networks.jnp
    jax_networks.jnp = _PreciseStats()
    try:
        yield
    finally:
        jax_networks.jnp = orig


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.abs(b))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cholesky", [False, True], ids=["raw", "cholesky"])
def test_float64_init_matches_jax(cholesky):
    """init_model at a float64 config draws JAX's float64 weights for the
    same key: every leaf and const float64; the uniform draws (every conv
    and FC weight and bias) equal bit for bit, the normal draws (sa, logstd,
    qu_m; sa = 1 + a draw, compared as its draw) within 4 ulps (XLA's
    float64 erfinv and log1p in numpy), the rest equal; the consts equal, xu within 4 ulps (linspace's rounding)."""
    kw = {"qu_s_cholesky": cholesky}
    rng = np.random.default_rng(0)
    glm = rng.normal(size=(int(np.prod(THIN["img_shape"])), 9))
    with jax.enable_x64(True):
        jp, jc = jax_init(jax.random.PRNGKey(3), JaxConfig(**F64, **kw), XU_RANGES, glm)
        jp, jc = to_np(jp), to_np(jc)
    pc = port_config(**kw)
    params, consts = init_model(pc, XU_RANGES, glm, key=np.array([0, 3], np.uint32),
                                device="cpu")
    want, want_c = params_from_jax(jp, jc, pc)
    normals = {"gp/sa", "gp/logstd", "gp/qu_m"}
    for (path, got), (_, w) in zip(tree_items(params), tree_items(want)):
        assert got.dtype == w.dtype == torch.float64, path
        if path in normals:
            shift = 1.0 if path == "gp/sa" else 0.0
            assert _ulps(got.numpy() - shift, w.numpy() - shift).max() <= 4, path
        else:
            np.testing.assert_array_equal(got.numpy(), w.numpy(), err_msg=path)
    for k in ("hrf", "glm_maps"):
        assert consts[k].dtype == torch.float64
        np.testing.assert_array_equal(consts[k].numpy(), want_c[k].numpy(), err_msg=k)
    assert consts["xu"].dtype == torch.float64
    assert _ulps(consts["xu"].numpy(), want_c["xu"].numpy()).max() <= 4


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

# (JAX's statistics, loss rtol, maps atol, gradient atol as a share of each
# leaf's largest entry): measured on these inputs, precise statistics: loss
# 1.5e-8, maps 3.1e-6, gradients 2.4e-4; JAX as it runs: loss 2.5e-5, maps
# 3.9e-3, gradients 6.6e-3
TIERS = {"precise_stats": (1e-7, 1e-5, 1e-3), "jax_as_it_runs": (1e-4, 1e-2, 2e-2)}


@pytest.mark.parametrize("flags", [{}, ORACLE_FLAGS], ids=["defaults", "oracle_flags"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_float64_forward_and_gradients_match_jax(tier, flags):
    """B=4, the same noise (JAX's float64 key chain): tot_loss, elbo,
    gp_kl, glm_reg, the 10 maps (base float32 on both sides: the sigmoid's
    cast; the rest float64) and the gradient leaf by leaf."""
    loss_rtol, maps_atol, grad_share = TIERS[tier]
    jcfg, pc = JaxConfig(**F64, **flags), port_config(**flags)
    rng = np.random.default_rng(0)
    glm = rng.normal(size=(jcfg.img_dim, 9)).astype(np.float32)
    covs, x = make_batch(jcfg.img_shape, 4)
    key = jax.random.PRNGKey(11)
    stats = jax_precise_f32_stats() if tier == "precise_stats" else contextlib.nullcontext()
    with jax.enable_x64(True), stats:
        jp, jc = jax_init(jax.random.PRNGKey(0), jcfg, XU_RANGES, glm)
        (jl, ja), jg = jax.value_and_grad(jax_forward, has_aux=True)(
            jp, jc, key, jnp.asarray(covs, jnp.float64), jnp.asarray(x, jnp.float64),
            jcfg, return_maps=True)
        noise = tuple(torch.from_numpy(a.copy()) for a in jax_noise(key, 4, jcfg.num_latents))
        jl, ja, jg, jp, jc = float(jl), to_np(ja), to_np(jg), to_np(jp), to_np(jc)
    tp, tc = params_from_jax(jp, jc, pc)
    prm = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, ta = forward(prm, tc, torch.tensor(covs, dtype=torch.float64),
                     torch.tensor(x, dtype=torch.float64), pc, noise=noise,
                     return_maps=True)
    tl.backward()
    assert tl.dtype == torch.float64 and all(n.dtype == torch.float64 for n in noise)
    np.testing.assert_allclose(tl.item(), jl, rtol=loss_rtol)
    for k in ("elbo", "gp_kl", "glm_reg"):
        np.testing.assert_allclose(ta[k].item(), float(ja[k]), rtol=loss_rtol, err_msg=k)
    for k in MAP_KEYS:
        got = ta["maps"][k].detach().numpy()
        assert got.dtype == ja["maps"][k].dtype == (np.float32 if k == "base" else np.float64)
        np.testing.assert_allclose(got, ja["maps"][k], atol=maps_atol, err_msg=k)
    jgrads, _ = params_from_jax(jg, None, pc)
    for (path, p), (_, w) in zip(tree_items(prm), tree_items(jgrads)):
        assert p.grad.dtype == w.dtype == torch.float64, path
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0,
                                   atol=grad_share * float(w.abs().max()), err_msg=path)


# ---------------------------------------------------------------------------
# the Trainer on host batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """(csv, xu_ranges): 2 subjects x 6 volumes at the thin grid."""
    from vaegam_tpu_torch.utils.stats import get_xu_ranges

    root = str(tmp_path_factory.mktemp("f64_subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=6, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    return csv, get_xu_ranges([csv, csv])


def test_float64_trainer_epoch_matches_jax(study):
    """One epoch of each package's Trainer at a float64 config through its
    own host DataLoader (12 volumes at batch 5: steps of 5, 5, 2), JAX's
    noise fed to the port, JAX's float32 statistics summed precisely: the
    init matches (1e-15), the batches are the same rows, every step's
    loss agrees within rtol 1e-7 and every parameter and Adam moment after
    the epoch within 2e-4 of its leaf's largest entry (measured 7.2e-5:
    Adam scales the float32 statistics' last-bit differences up to steps of
    lr), logkvar within lr a step (its gradient is rounding, as in
    test_oracle_training_tracks_jax).  Both models stay float64 throughout."""
    csv, xu = study
    jcfg, pc = JaxConfig(**F64, **ORACLE_FLAGS), port_config(**ORACLE_FLAGS)
    steps = []
    with jax.enable_x64(True), jax_precise_f32_stats():
        jt = JaxTrainer(jcfg, xu, seed=1, enable_tb=False)
        pt = Trainer(pc, xu, seed=1, enable_tb=False, device="cpu")
        want, _ = params_from_jax(to_np(jt.params), None, pc)
        for (path, a), (_, b) in zip(tree_items(pt.params), tree_items(want)):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-15,
                                       atol=1e-15, err_msg=path)
        pt._set_params(want)   # the same weights to the last bit
        inner = jt._train_step

        def jax_step(params, opt_state, key, covs, x):
            assert x.dtype == covs.dtype == jnp.float64
            steps.append((np.asarray(x), jax_noise(key, x.shape[0], jcfg.num_latents)))
            out = inner(params, opt_state, key, covs, x)
            steps[-1] += (float(out[2]),)
            return out

        jt._train_step = jax_step
        step, port_losses = pt.train_step, []

        def port_step(covs, x, noise=None):
            assert x.dtype == covs.dtype == torch.float64
            want_x, draws, _ = steps[len(port_losses)]
            np.testing.assert_array_equal(x.numpy(), want_x)
            loss, aux = step(covs, x, noise=tuple(torch.from_numpy(d.copy()) for d in draws))
            port_losses.append(float(loss))
            return loss, aux

        pt.train_step = port_step
        jl = jt.train_epoch(jax_loaders(batch_size=5, train_csv=csv, test_csv=csv,
                                        seed=1)["Shuffled_train"])
        pl = pt.train_epoch(setup_data_loaders(batch_size=5, train_csv=csv, test_csv=csv,
                                               seed=1)["Shuffled_train"])
        mine = [params_to_jax(pt.params, None, pc)[0]]
        mine += [params_to_jax(pt.opt_state[k], None, pc)[0] for k in ("mu", "nu")]
        adam = jt.opt_state.inner_state[0]
        theirs = [to_np(jt.params), to_np(adam.mu), to_np(adam.nu)]
    assert [s[0].shape[0] for s in steps] == [5, 5, 2]
    np.testing.assert_allclose(port_losses, [s[2] for s in steps], rtol=1e-7)
    np.testing.assert_allclose(pl, jl, rtol=1e-7)
    for what, got, want_tree in zip(("param", "mu", "nu"), mine, theirs):
        for (path, g), (_, w) in zip(tree_items(got), tree_items(want_tree)):
            assert g.dtype == w.dtype == np.float64, f"{what} {path}"
            bound = (len(steps) * pt.lr if path == "gp/logkvar"
                     else 2e-4 * max(1e-30, np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_float64_refuses_the_conv5_kernel_and_other_dtypes():
    with pytest.raises(ValueError, match="conv5_kernel=False"):
        VAEGAMConfig(dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        VAEGAMConfig(dtype=torch.float16)
    assert port_config().conv5_kernel is False


def test_float64_refuses_the_device_cache_before_the_first_step():
    """The device cache's gather restores float32 (JAX's raises in its conv
    on float32 against float64): the port refuses before any step, naming
    the host loaders, and changes nothing."""
    covs, vols = make_batch(THIN["img_shape"], 6)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, device="cpu")
    t = Trainer(port_config(), XU_RANGES, seed=2, enable_tb=False, device="cpu")
    before = {p: v.clone() for p, v in tree_items(t.params)}
    with pytest.raises(ValueError, match="setup_data_loaders or setup_prefetch_loaders"):
        t.train_epoch(loader)
    assert int(t.opt_state["count"]) == 0 and t.epoch == 0
    assert all(torch.equal(before[p], v) for p, v in tree_items(t.params))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class _HostBatches:
    """A host loader of in-memory numpy batches (float32, as the dataset's)."""

    def __init__(self, n=8, batch=4, seed=7):
        covs, vols = make_batch(THIN["img_shape"], n, seed=seed)
        self.batches = [{"covariates": covs[i:i + batch], "volume": vols[i:i + batch]}
                        for i in range(0, n, batch)]
        self.num_samples = n

    def __iter__(self):
        return iter(self.batches)


def test_float64_checkpoint_crosses_both_ways(tmp_path):
    """A float64 port Trainer trains one epoch on host batches and saves;
    the JAX Trainer at a float64 config loads it with equal float64 params
    and Adam moments, saves again, and a port Trainer loads that back to
    the same tensors, bit for bit, every one float64."""
    from vaegam_tpu_torch.train.checkpoint import flatten

    t = Trainer(port_config(), XU_RANGES, save_dir=str(tmp_path), seed=2, enable_tb=False,
                device="cpu")
    t.train_epoch(_HostBatches())
    path = str(tmp_path / "port.tar")
    t.save_state(path)
    with jax.enable_x64(True):
        jt = JaxTrainer(JaxConfig(**F64), XU_RANGES, None, save_dir=str(tmp_path),
                        enable_tb=False)
        jt.load_state(path)
        want_p, _ = params_to_jax(t.params, t.consts, t.config)
        got = flatten(to_np(jt.params)) + jax.tree_util.tree_leaves(to_np(jt.opt_state))
        want = flatten(want_p) + flatten(t._opt_state_to_jax())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert jt.params["gp"]["qu_m"].dtype == np.float64
        back = str(tmp_path / "jax.tar")
        jt.save_state(back)
    reader = Trainer(port_config(), XU_RANGES, seed=5, enable_tb=False, device="cpu")
    reader.load_state(back)
    for tree in ("params", "mu", "nu"):
        a_tree = reader.params if tree == "params" else reader.opt_state[tree]
        b_tree = t.params if tree == "params" else t.opt_state[tree]
        for (path_, a), (_, b) in zip(tree_items(a_tree), tree_items(b_tree)):
            assert a.dtype == b.dtype == torch.float64 and torch.equal(a, b), f"{tree} {path_}"
    assert int(reader.opt_state["count"]) == 2
    assert np.isfinite(reader.train_epoch(_HostBatches()))
