"""The checkpoint converters against the JAX package's.

``vaegam_tpu_torch.cli.import_torch_ckpt`` / ``export_torch_ckpt`` and their
helpers in ``vaegam_tpu_torch.utils.torch_port`` against
``vaegam_tpu.cli.import_torch_ckpt`` / ``export_torch_ckpt`` and
``vaegam_tpu.utils.torch_port`` / ``torch_export``: on a reference-format
``.tar`` that the test builds itself (the JAX export of a JAX checkpoint,
as tests/test_torch_export.py::test_export_import_full_circle does), both
packages write the same files.  The JAX import hard-codes the reference
grid's flattened sizes, so the model is nf=2 with 8 latents at 41x49x35.
"""

import os

import numpy as np
import pytest
import torch

import jax
import optax

from e2e_helpers import IMG_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.cli.export_torch_ckpt import convert as jax_export
from vaegam_tpu.cli.import_torch_ckpt import convert as jax_import
from vaegam_tpu.models import VAEGAMConfig as JaxConfig, init_model as jax_init
from vaegam_tpu.models.vaegam import hrf_kernel as jax_hrf_kernel
from vaegam_tpu.train.checkpoint import save_checkpoint as jax_save
from vaegam_tpu.utils import torch_export as jax_te, torch_port as jax_tp

from vaegam_tpu_torch.cli.export_torch_ckpt import convert as port_export
from vaegam_tpu_torch.cli.import_torch_ckpt import convert as port_import
from vaegam_tpu_torch.cli.train import main as train_main
from vaegam_tpu_torch.models import MAP_KEYS, VAEGAMConfig, forward
from vaegam_tpu_torch.train import load_checkpoint
from vaegam_tpu_torch.train.checkpoint import flatten
from vaegam_tpu_torch.utils import torch_port
from vaegam_tpu_torch.utils.jax_params import params_from_jax, params_to_jax
from vaegam_tpu_torch.utils.tree import tree_items

from torch_port_common import XU_RANGES, make_batch, to_np

MODEL = dict(nf=2, num_latents=8, img_shape=IMG_SHAPE)


def _jax_model(cholesky=False, seed=3):
    config = JaxConfig(qu_s_cholesky=cholesky, **MODEL)
    params, consts = jax_init(jax.random.PRNGKey(seed), config, XU_RANGES, None)
    return config, to_np(params), to_np(consts)


def _jax_checkpoint(path, cholesky=False):
    """A JAX Trainer-format checkpoint of a fresh model, as the JAX tests
    write one."""
    _, params, consts = _jax_model(cholesky)
    jax_save(str(path), params, optax.adam(1e-3).init(params), epoch=7,
             loss={"train": {0: np.float32(1.5), 1: np.float32(1.25)}, "test": {}},
             z_dim=MODEL["num_latents"] + 9, lr=1e-3, save_dir=str(path.parent),
             glm_reg_scale=1.0, gp_kl_scale=10.0, inducing_pts=6,
             consts={"xu": consts["xu"], "hrf": np.asarray(jax_hrf_kernel()),
                     "glm_maps": None})
    return str(path)


def _assert_same(a, b, what):
    """Equal nested checkpoint contents: the same keys, types, dtypes,
    shapes and values, bit for bit."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), what
        for k in b:
            _assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif torch.is_tensor(b):
        assert type(a) is type(b) and a.dtype == b.dtype, what
        assert a.shape == b.shape and torch.equal(a, b), what
    elif isinstance(b, np.ndarray) or np.isscalar(b) and not isinstance(b, (str, bool)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("cholesky", [False, True], ids=["raw", "cholesky"])
def test_layout_helpers_match_jax(cholesky):
    """export_layer_state / export_gp_params give the JAX functions' arrays
    bit for bit (a Cholesky bank as the same dense L L^T), and
    port_layer_state / port_gp_params bring them back as the JAX
    functions do."""
    _, params, consts = _jax_model(cholesky)
    layers = torch_port.export_layer_state(params, MODEL["nf"])
    _assert_same(layers, {k: {n: np.asarray(a) for n, a in v.items()}
                          for k, v in jax_te.export_layer_state(params, MODEL["nf"]).items()},
                 "layers")
    gp = torch_port.export_gp_params(params["gp"], consts["xu"])
    _assert_same(gp, to_np(jax_te.export_gp_params(params["gp"], consts["xu"])), "gp")
    _assert_same(torch_port.port_layer_state(layers, MODEL["nf"]),
                 to_np(jax_tp.port_layer_state(layers, MODEL["nf"])), "port layers")
    _assert_same(torch_port.port_gp_params(gp), to_np(jax_tp.port_gp_params(gp)), "port gp")


@pytest.fixture(scope="module")
def reference_tar(tmp_path_factory):
    """A reference-format .tar: the JAX export of a JAX checkpoint."""
    d = tmp_path_factory.mktemp("reference")
    out = str(d / "reference.tar")
    jax_export(_jax_checkpoint(d / "jax.tar"), out)
    return out


def test_import_writes_the_jax_checkpoint(reference_tar, tmp_path):
    """Both packages' import of one reference .tar: the same checkpoint,
    key for key (params, a fresh optax Adam state, consts with a float32
    HRF and no GLM maps, the scalars), bit for bit."""
    ours, theirs = tmp_path / "port" / "c.tar", tmp_path / "jax" / "c.tar"
    port_import(reference_tar, str(ours), nf=MODEL["nf"])
    jax_import(reference_tar, str(theirs), nf=MODEL["nf"])
    mine, want = load_checkpoint(str(ours)), load_checkpoint(str(theirs))
    assert set(mine) == set(want)
    for key in set(want) - {"optimizer_state", "save_dir"}:
        _assert_same(mine[key], want[key], key)
    assert mine["save_dir"] == str(ours.parent) and want["save_dir"] == str(theirs.parent)
    got_opt, want_opt = flatten(mine["optimizer_state"]), flatten(want["optimizer_state"])
    _assert_same(got_opt, want_opt, "optimizer_state")
    assert int(got_opt[0]) == 0 and all(not np.any(a) for a in got_opt[1:])
    assert mine["params"]["epsilon"].dtype == np.float32 and "qu_S" in mine["params"]["gp"]


@pytest.mark.parametrize("cholesky", [False, True], ids=["raw", "cholesky"])
def test_export_writes_the_jax_tar(tmp_path, cholesky):
    """Both packages' export of one checkpoint: .tar files with the same
    contents under torch.load(weights_only=True) (float64 epsilon
    nn.Parameter, nn.Parameter GP leaves, a plain xu, 0-d logkvar/log_ls,
    plain Python scalars, a fresh torch Adam over the reference's 97
    parameters)."""
    ckpt = _jax_checkpoint(tmp_path / "jax.tar", cholesky)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    port_export(ckpt, str(tmp_path / "a" / "ref.tar"))
    jax_export(ckpt, str(tmp_path / "b" / "ref.tar"))
    mine = torch.load(str(tmp_path / "a" / "ref.tar"))
    want = torch.load(str(tmp_path / "b" / "ref.tar"))
    assert mine.pop("save_dir") == str(tmp_path / "a")
    assert want.pop("save_dir") == str(tmp_path / "b")
    _assert_same(mine, want, "tar")
    assert isinstance(mine["epsilon"], torch.nn.Parameter)
    assert mine["epsilon"].dtype == torch.float64
    assert mine["gp_params"]["x"]["logkvar"].shape == ()
    assert len(mine["optimizer_state"]["param_groups"][0]["params"]) == 97


def test_export_refuses_a_checkpoint_without_xu(tmp_path):
    _, params, _ = _jax_model()
    path = str(tmp_path / "noxu.tar")
    jax_save(path, params, optax.adam(1e-3).init(params), epoch=1,
             loss={"train": {}, "test": {}}, z_dim=17, lr=1e-3, save_dir=str(tmp_path),
             glm_reg_scale=1.0, gp_kl_scale=10.0, inducing_pts=6)
    with pytest.raises(ValueError, match="xu"):
        port_export(path, str(tmp_path / "out.tar"))


@pytest.mark.parametrize("cholesky", [False, True], ids=["raw", "cholesky"])
def test_full_circle_through_the_port(tmp_path, cholesky):
    """checkpoint -> the port's export -> the port's import.  A raw-qu_S
    checkpoint comes back bit for bit (params and xu).  A Cholesky one
    comes back with the dense qu_S = L L^T in place of qu_S_raw: every
    other leaf bit for bit, and a deterministic B=2 maps forward of the
    round-tripped params within 1e-6 of the original's (float32, the
    reading: 0 on these weights; L L^T is the forward's own product)."""
    ckpt = _jax_checkpoint(tmp_path / "jax.tar", cholesky)
    ref, back = str(tmp_path / "ref.tar"), str(tmp_path / "back.tar")
    port_export(ckpt, ref)
    port_import(ref, back, nf=MODEL["nf"])
    orig, circ = load_checkpoint(ckpt), load_checkpoint(back)
    _assert_same(circ["consts"]["xu"], orig["consts"]["xu"], "xu")
    o_gp, c_gp = dict(orig["params"]["gp"]), dict(circ["params"]["gp"])
    if cholesky:
        assert "qu_S_raw" in o_gp and "qu_S" in c_gp
        o_gp.pop("qu_S_raw")
        c_gp.pop("qu_S")
    _assert_same({**circ["params"], "gp": c_gp}, {**orig["params"], "gp": o_gp}, "params")
    config = VAEGAMConfig(qu_s_cholesky=cholesky, **MODEL)
    covs, x = make_batch(IMG_SHAPE, 2)
    maps = []
    for state in (orig, circ):
        params, consts = params_from_jax(state["params"], state["consts"], config)
        _, aux = forward(params, consts, torch.tensor(covs), torch.tensor(x), config,
                         return_maps=True, deterministic=True)
        maps.append(aux["maps"])
    for k in MAP_KEYS:
        np.testing.assert_allclose(maps[1][k].numpy(), maps[0][k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_converted_checkpoint_loads_in_from_ckpt(reference_tar, tmp_path):
    """The port's import of a reference .tar resumes in the port's train
    CLI (--from_ckpt): its params load as written (Adam restarts: the
    imported state is plain Adam, the CLI's Trainer skips non-finite
    steps, as the JAX Trainer restarts it), and one epoch trains on."""
    ckpt = str(tmp_path / "checkpoint_007.tar")
    port_import(reference_tar, ckpt, nf=MODEL["nf"])
    root = str(tmp_path / "subjects")
    make_subject_tree(root, n_subjs=2, n_vols=4, img_shape=IMG_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    trainer, _ = train_main(["--train_csv", csv, "--test_csv", csv, "--save_dir",
                             str(tmp_path / "run"), "--batch-size", "4", "--nf", "2",
                             "--num_latents", "8", "--epochs", "1", "--device", "cpu",
                             "--no_outputs", "--from_ckpt", "--ckpt_path", ckpt,
                             "--save_freq", "100", "--test_freq", "100"])
    assert trainer.epoch == 8 and np.isfinite(trainer.loss["train"][7])
    assert int(trainer.opt_state["count"]) == 2
    trained, _ = params_to_jax(trainer.params, None, trainer.config)
    saved = load_checkpoint(ckpt)["params"]
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(tree_items(trained), tree_items(saved)))
