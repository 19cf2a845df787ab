"""The port's data parallelism (vaegam_tpu_torch.parallel) against the JAX
package's mesh and against the port's single-process step.

Two gloo ranks on the CPU (tests/torch_dp_worker.py: one group for this
module, plus a group of one on each rank) run the port's collective step;
the JAX side is its 8-virtual-device mesh (tests/conftest.py), as
tests/test_parallel.py uses it.  Thin model (nf=2, 8 latents, 21x25x21),
JAX's weights (``params_from_jax``) and JAX's noise (``jax_noise``).

  * A 2-rank step against JAX's 8-device step: in float64 (both sides, see
    tests/torch_port_common.py) the loss within rtol 1e-9 and each
    gradient leaf within 1e-7 of its largest entry, then one Trainer step
    through Adam; in fp32 at JAX's own DP bounds (tests/test_parallel.py:
    202-237: loss rtol 2e-5, gradients 2e-4 of each leaf's largest entry),
    against JAX's step and the port's single-process one.
  * The batch-coupled pieces one by one, at a world of one and of two,
    against the single-process port: the norm statistics, the d-floor, the
    gain sample with its HRF (the maps), glm_reg and the ELBO terms, a
    non-finite gradient that every rank skips.
  * A batch the ranks do not divide: refused for a host batch, as JAX's
    placement refuses it; split unevenly by the device cache, whose in-jit
    gather XLA splits without refusing.
  * The device cache and the prefetch loader at 2 ranks; the train CLI with
    --multihost, its output stage and a resume; the refusals; and
    ``dryrun_multichip(2)``.
"""

import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.models import forward as jax_forward
from vaegam_tpu.parallel import make_data_mesh as jax_data_mesh

from vaegam_tpu_torch.cli.train import main
from vaegam_tpu_torch.data import DeviceResidentLoader, FMRIDataset
from vaegam_tpu_torch.models import forward
from vaegam_tpu_torch.models.networks import batch_stat_norm
from vaegam_tpu_torch.models.vaegam import d_floor
from vaegam_tpu_torch.parallel import DataMesh, batch_rows
from vaegam_tpu_torch.parallel.dryrun import dryrun_multichip
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import params_from_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_dp_worker import Ranks
from torch_port_common import (THIN, f64_jax, jax_float64, jax_noise, make_batch,
                               make_model, to_np, torch_tensors)

WORLDS = [1, 2]
TWO_RANKS = DataMesh(0, 2, "gloo", torch.device("cpu"))


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(2)
    yield r
    r.close()


@pytest.fixture(scope="module")
def model():
    return make_model(THIN)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The design csv of tests/test_multihost.py's toy study: 2 subjects x 8
    volumes, small grid."""
    root = str(tmp_path_factory.mktemp("dp_subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=8, seed=0, img_shape=SMALL_SHAPE)
    return make_design_csv(root, os.path.join(root, "design.csv"))


def _np(tree):
    return tree_map(lambda t: None if t is None else t.detach().numpy(), tree)


def _inputs(model, batch, key=11, seed=1):
    jc, pc, params, consts, tp, tc = model
    covs, x = make_batch(jc.img_shape, batch, seed=seed)
    noise = jax_noise(jax.random.PRNGKey(key), batch, jc.num_latents)
    return dict(config=pc, params=_np(tp), consts=_np(tc), covs=covs, x=x, noise=noise)


def _single(inp, dtype=torch.float32):
    """The single-process port: (loss, aux, the gradient tree)."""
    p = tree_map(lambda a: torch.tensor(a, dtype=dtype, requires_grad=True), inp["params"])
    c = tree_map(lambda a: None if a is None else torch.tensor(a, dtype=dtype), inp["consts"])
    covs, x = torch_tensors(inp["covs"], inp["x"], dtype=dtype)
    loss, aux = forward(p, c, covs, x, inp["config"],
                        noise=torch_tensors(*inp["noise"], dtype=dtype))
    loss.backward()
    return float(loss.detach()), aux, tree_map(lambda t: t.grad.numpy(), p)


def _assert_leaves_close(got, want, share, what):
    """Each leaf within `share` of its largest entry."""
    for path, a, b in zip([p for p, _ in tree_items(want)], got,
                          [v for _, v in tree_items(want)]):
        b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(np.asarray(a, np.float64) / scale, b / scale,
                                   atol=share, err_msg=f"{what} {path}")


def _ranks_agree(outs, key):
    for o in outs[1:]:
        for a, b in zip(outs[0][key], o[key]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the step against JAX's mesh
# ---------------------------------------------------------------------------

def test_two_rank_step_matches_jax_mesh_float64(ranks, model):
    """2 ranks against JAX's 8-device mesh, both in float64: the loss, every
    gradient leaf, and one Trainer step through Adam (params at 1e-6 of
    each leaf's largest entry, as tests/test_torch_port_train.py holds a
    single-process step); the ranks hold the same bytes after it."""
    jc, pc, params, consts, *_ = model
    key = jax.random.PRNGKey(11)
    with jax_float64():  # JAX's float64 draws
        inp = _inputs(model, 8)
    mesh = jax_data_mesh()
    dsh = NamedSharding(mesh, P("data"))
    tx = optax.apply_if_finite(optax.adam(1e-3), max_consecutive_errors=100000)
    with jax_float64():
        jp, jcs = f64_jax(params), f64_jax(consts)
        jcovs = jax.device_put(np.asarray(inp["covs"], np.float64), dsh)
        jx = jax.device_put(np.asarray(inp["x"], np.float64), dsh)
        (jl, _), jg = jax.jit(jax.value_and_grad(jax_forward, has_aux=True),
                              static_argnums=5)(jp, jcs, key, jcovs, jx, jc)
        updates, _ = tx.update(jg, tx.init(jp), jp)
        jp1 = optax.apply_updates(jp, updates)
        jg, jp1, jl = to_np(jg), to_np(jp1), float(jl)
    outs = ranks.run("step", dtype="float64", trainer_step=True, **inp)
    assert outs[0]["loss"] == outs[1]["loss"] == outs[0]["trainer_loss"]
    _ranks_agree(outs, "grads")
    assert outs[0]["digests"][0] == outs[0]["digests"][1]
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-9)
    want, _ = params_from_jax(jg, None, pc, "cpu")
    _assert_leaves_close(outs[0]["grads"], want, 1e-7, "grad")
    want_p, _ = params_from_jax(jp1, None, pc, "cpu")
    _assert_leaves_close([v for _, v in tree_items(outs[0]["params"])], want_p, 1e-6,
                         "param after Adam")


def test_two_rank_step_matches_jax_mesh_fp32(ranks, model):
    """fp32: 2 ranks against JAX's 8-device step and against the port's
    single-process step, at JAX's own DP bounds (loss rtol 2e-5, gradients
    2e-4 of each leaf's largest entry); the Trainer's first Adam moment is
    0.1 x the summed gradient, the same bytes on both ranks."""
    jc, pc, params, consts, *_ = model
    inp = _inputs(model, 8)
    dsh = NamedSharding(jax_data_mesh(), P("data"))
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_forward, has_aux=True), static_argnums=5)(
        params, consts, jax.random.PRNGKey(11), jax.device_put(inp["covs"], dsh),
        jax.device_put(inp["x"], dsh), jc)
    jax_grads, _ = params_from_jax(to_np(jg), None, pc, "cpu")
    loss, _, single = _single(inp)
    outs = ranks.run("step", dtype="float32", trainer_step=True, **inp)
    assert outs[0]["loss"] == outs[1]["loss"]
    _ranks_agree(outs, "grads")
    assert outs[0]["digests"][0] == outs[0]["digests"][1]
    for want_loss, want, what in ((float(jl), jax_grads, "JAX"), (loss, single, "single")):
        np.testing.assert_allclose(outs[0]["loss"], want_loss, rtol=2e-5, err_msg=what)
        _assert_leaves_close(outs[0]["grads"], want, 2e-4, f"grad vs {what}")
    _assert_leaves_close([v / 0.1 for _, v in tree_items(outs[1]["mu"])], single, 2e-4,
                         "first moment / 0.1")


def test_two_rank_step_in_the_tpu_arm_matches_one_process(ranks, model):
    """``tpu_products`` under data parallel: the 2 ranks' float64 step (loss
    and summed gradients, the HRF and the gain sample over the global batch)
    against the single-process step in the arm, at the float64 bounds (loss
    rtol 1e-9, gradients 1e-7 of each leaf's largest entry); the step
    without the arm differs."""
    inp = _inputs(model, 8)
    inp["config"] = dataclasses.replace(inp["config"], tpu_products=True)
    loss, _, single = _single(inp, torch.float64)
    outs = ranks.run("step", dtype="float64", trainer_step=False, **inp)
    assert outs[0]["loss"] == outs[1]["loss"]
    _ranks_agree(outs, "grads")
    np.testing.assert_allclose(outs[0]["loss"], loss, rtol=1e-9)
    _assert_leaves_close(outs[0]["grads"], single, 1e-7, "grad vs single")
    off, _, _ = _single(dict(inp, config=model[1]), torch.float64)
    assert abs(off - loss) > 1e-6 * abs(loss)


# ---------------------------------------------------------------------------
# the batch-coupled pieces, at a world of one and of two
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 3], ids=["encoder", "decoder_groups"])
@pytest.mark.parametrize("world", WORLDS)
def test_norm_statistics_are_the_global_batch(ranks, world, groups):
    """batch_stat_norm over each rank's rows of 5 rows a group (3 + 2 at two
    ranks) equals the single-process norm, forward and backward (float64:
    1e-12)."""
    rng = np.random.default_rng(4)
    x = rng.normal(2.0, 3.0, size=(5 * groups, 3, 2, 3, 2))
    p = {"scale": rng.normal(size=3), "shift": rng.normal(size=3)}
    cot = rng.normal(size=x.shape)
    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    want = batch_stat_norm(xt, pt, groups)
    gx, gs, gb = torch.autograd.grad(want, [xt, pt["scale"], pt["shift"]], torch.tensor(cot))
    n = 5

    def rows(a, lo, hi):
        return a.reshape(groups, n, *a.shape[1:])[:, lo:hi].reshape(-1, *a.shape[1:])

    for out, dx, ds, db, (lo, hi) in ranks.run("norm", world=world, x=x, p=p,
                                               groups=groups, cotangent=cot):
        np.testing.assert_allclose(out, rows(want.detach().numpy(), lo, hi), atol=1e-12)
        np.testing.assert_allclose(dx, rows(gx.numpy(), lo, hi), atol=1e-12)
        np.testing.assert_allclose(ds, gs.numpy(), rtol=1e-12)
        np.testing.assert_allclose(db, gb.numpy(), rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_d_floor_is_global(ranks, world):
    """A tiny d on the last rank's rows shifts every rank's d."""
    d = np.random.default_rng(5).uniform(0.5, 1.5, size=(4, 3))
    d[3, 1] = 1e-9
    want = d_floor(torch.tensor(d)).numpy()
    assert (want != d).all()
    for (lo, hi), got in ranks.run("floor", world=world, d=d):
        np.testing.assert_array_equal(got, want[lo:hi])


@pytest.mark.parametrize("world", WORLDS)
def test_gain_sample_and_maps_are_the_global_batch(ranks, model, world):
    """The gain sample spans the global batch on every rank (the B x B
    covariances, the jittered Cholesky, the HRF along the batch axis):
    beta_mean, its variances, the largest gain and the fallback count equal
    the single-process ones bit for bit; each rank's 10 maps are the
    single-process maps' rows (1e-5 of their largest entry, fp32)."""
    inp = _inputs(model, 6, key=3)
    with torch.no_grad():
        _, aux = forward(*[tree_map(lambda a: None if a is None else torch.tensor(a), t)
                           for t in (inp["params"], inp["consts"])],
                         *torch_tensors(inp["covs"], inp["x"]), inp["config"],
                         noise=torch_tensors(*inp["noise"]), return_maps=True)
    for out in ranks.run("maps", world=world, **inp):
        lo, hi = out["rows"]
        for k in ("beta_mean", "beta_cov_diag", "gains_absmax", "mvn_fallbacks"):
            np.testing.assert_array_equal(out["aux"][k], aux[k].numpy(), err_msg=k)
        for k, m in aux["maps"].items():
            want = m.numpy()[lo:hi]
            np.testing.assert_allclose(out["maps"][k], want,
                                       atol=1e-5 * np.abs(m.numpy()).max(), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_glm_reg_and_elbo_are_the_global_batch(ranks, model, world):
    """glm_reg (the GLOBAL batch size times the ranks' summed distances),
    the ELBO, its KL and log-likelihood means and the loss equal the
    single-process ones on every rank (fp32, rtol 2e-5)."""
    inp = _inputs(model, 6, key=3)
    loss, aux, _ = _single(inp)
    outs = ranks.run("maps", world=world, **inp)
    for out in outs:
        assert out["loss"] == outs[0]["loss"]
        np.testing.assert_allclose(out["loss"], loss, rtol=2e-5)
        for k in ("glm_reg", "elbo", "kl_z_mean", "log_prob_mean", "gp_kl"):
            np.testing.assert_allclose(out["aux"][k], aux[k].detach().numpy(), rtol=2e-5,
                                       err_msg=k)
    assert aux["glm_reg"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_nonfinite_gradient_is_skipped_on_every_rank(ranks, model, world):
    """A NaN volume on the last rank's rows makes the summed gradient
    non-finite on every rank: each skips the update and counts it, and the
    ranks keep the same parameters."""
    inp = _inputs(model, 4)
    inp["x"][3, 2, 2, 2] = np.nan
    for loss, skipped, count, unchanged, digests in ranks.run("skip", world=world, **inp):
        assert not np.isfinite(loss)
        assert (skipped, count, unchanged) == (1, 0, True)
        assert len(set(digests)) == 1


# ---------------------------------------------------------------------------
# uneven batches, the loaders
# ---------------------------------------------------------------------------

def test_batch_the_ranks_do_not_divide_behaves_as_jax(ranks, model):
    """JAX refuses to place a batch of 3 rows over its mesh and splits the
    same batch inside its device cache's jitted gather; so the port: a host
    batch of 3 at 2 ranks is refused, the device cache's last batch of 3
    splits 2 + 1 and its loss and summed gradients equal the single-process
    ones (fp32 DP bounds)."""
    mesh = jax_data_mesh()
    with pytest.raises(ValueError, match="divisible|evenly divide"):
        jax.device_put(np.zeros((3, 2), np.float32), NamedSharding(mesh, P("data")))
    take = jax.jit(lambda v, i: jax.lax.with_sharding_constraint(
        jnp.take(v, i, axis=0), NamedSharding(mesh, P("data"))))
    np.testing.assert_array_equal(np.asarray(take(jnp.arange(14.0).reshape(7, 2),
                                                  np.arange(4, 7))),
                                  np.arange(8.0, 14.0).reshape(3, 2))

    inp = _inputs(model, 7, key=5)
    tail = dict(inp, covs=inp["covs"][4:], x=inp["x"][4:],
                noise=jax_noise(jax.random.PRNGKey(5), 3, THIN["num_latents"]))
    loss, _, grads = _single(tail)
    outs = ranks.run("uneven", world=2, config=inp["config"], params=inp["params"],
                     consts=inp["consts"], vols=inp["x"], covs=inp["covs"],
                     noise=tail["noise"])
    assert [o[0] for o in outs] == [(0, 2), (2, 3)]
    for rows, l, g, err in outs:
        np.testing.assert_allclose(l, loss, rtol=2e-5)
        for a, (_, b) in zip(g, tree_items(grads)):
            scale = max(np.abs(b).max(), 1e-12)
            np.testing.assert_allclose(a / scale, b / scale, atol=2e-4)
        assert "does not divide evenly" in err


def test_device_cache_and_prefetch_give_each_rank_its_rows(ranks, study):
    """Two shuffled epochs at batch 4 over 16 volumes: each rank's batches
    are the single-process device cache's, the covariates and volume
    numbers whole and the volumes this rank's block; the prefetch loader
    decodes only its own rows, 16 of the 32 a rank."""
    csv = study
    one = DeviceResidentLoader(FMRIDataset(csv), 4, shuffle=True, seed=3, device="cpu")
    want, sels = [], []
    for epoch in (0, 1):
        one.set_epoch(epoch)
        want += [(b["vol_num"], b["covariates"].numpy(), b["volume"].numpy()) for b in one]
        sels += list(one.iter_index_batches())
    outs = ranks.run("loaders", world=2, csv=csv, batch=4)
    for rank, out in enumerate(outs):
        lo, hi = batch_rows(4, DataMesh(rank, 2, "gloo", torch.device("cpu")))
        for name in ("cache", "prefetch"):
            assert len(out[name]) == len(want) == 8
            for (vn, c, v), (wvn, wc, wv) in zip(out[name], want):
                np.testing.assert_array_equal(vn, wvn)
                np.testing.assert_array_equal(c, wc)
                np.testing.assert_array_equal(v, wv[lo:hi])
        assert out["decoded"] == [int(i) for sel in sels for i in sel[lo:hi]]
        assert len(out["decoded"]) == 16


# ---------------------------------------------------------------------------
# the train CLI with --multihost
# ---------------------------------------------------------------------------

def _cli_argv(study, save_dir, *extra):
    """tests/test_multihost.py's CLI arguments, on the CPU."""
    return ["--train_csv", study, "--test_csv", study, "--save_dir", str(save_dir),
            "--batch-size", "4", "--nf", "2", "--num_latents", "8",
            "--img_shape", *map(str, SMALL_SHAPE), "--device", "cpu",
            "--save_freq", "1", "--test_freq", "1", *extra]


@pytest.fixture(scope="module")
def cli_run(ranks, study, tmp_path_factory):
    """3 epochs and the output stage at 2 ranks: (save dir, each rank's
    (train losses, test losses, output-stage records))."""
    out = tmp_path_factory.mktemp("dp_cli")
    return out, ranks.run("cli", world=2, argv=_cli_argv(study, out, "--epochs", "3"))


def test_cli_multihost_matches_one_process_and_writes_once(cli_run, study, tmp_path):
    """Both ranks print the same losses, and epochs 0 and 1 are within rtol
    2e-3 of the single-process CLI's (the bound and the study of
    tests/test_multihost.py); rank 0 alone wrote the checkpoints, the GP
    CSVs, the 16 x 10 recon maps and the 10 grand averages."""
    out, ((train0, test0, stats0), (train1, test1, stats1)) = cli_run
    assert train0 == train1 and test0 == test1 and sorted(train0) == [0, 1, 2]
    trainer, _ = main(_cli_argv(study, tmp_path, "--epochs", "2", "--no_outputs"))
    np.testing.assert_allclose([train0[0], train0[1]],
                               [trainer.loss["train"][0], trainer.loss["train"][1]],
                               rtol=2e-3)
    written = {"recons", "avg_maps_s", "gp_plots_s", "umap_backend"}
    assert written <= set(stats0) and not written & set(stats1)
    assert (out / "checkpoint_002.tar").exists()
    assert len(list((out / "003_GP_plots").glob("*.csv"))) == 6
    recon = out / "reconstructions" / "003_model_recons"
    assert len(list(recon.glob("*/vol_*/recon_*.nii"))) == 16 * 10
    grand = list((out / "reconstructions" / "003_avg_model_recons").glob("*_avg.nii"))
    assert len(grand) == 10


def test_cli_multihost_resume_continues_the_run(ranks, cli_run, study, tmp_path):
    """Both ranks resume the 3-epoch run from checkpoint_001 for epoch 2:
    its loss is the unbroken run's at print precision, as
    tests/test_multihost.py:246-295 checks the JAX CLI."""
    out, a = cli_run
    b = ranks.run("cli", world=2, argv=_cli_argv(
        study, tmp_path, "--epochs", "1", "--no_outputs", "--from_ckpt",
        "--ckpt_path", str(out / "checkpoint_001.tar")))
    assert b[0][0] == b[1][0] and sorted(b[0][0]) == [0, 1, 2]
    assert f"{b[0][0][2]:.4f}" == f"{a[0][0][2]:.4f}"


# ---------------------------------------------------------------------------
# refusals, the dry run
# ---------------------------------------------------------------------------

def test_epoch_scan_under_gloo_and_row_sharding_are_refused(model):
    """``epoch_scan`` captures the step's collectives into a CUDA graph,
    which gloo cannot; row sharding under a multi-process mesh is refused
    by both device loaders, as JAX refuses it."""
    jc, pc, *_ = model
    with pytest.raises(ValueError, match="NCCL"):
        Trainer(pc, [[-2.0, 2.0]] * 6, mesh=TWO_RANKS, epoch_scan=True)
    vols = np.zeros((4,) + jc.img_shape, np.float32)
    with pytest.raises(ValueError, match="multi-process mesh"):
        DeviceResidentLoader.from_arrays(vols, np.zeros((4, 8), np.float32),
                                         num_shards=2, mesh=TWO_RANKS)


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2)
    assert "2 gloo ranks agree OK" in capsys.readouterr().out
