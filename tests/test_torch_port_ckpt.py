"""Checkpoints across the two packages, and resume within the port.

Both packages write one pickle of numpy trees with params in the JAX layout
(vaegam_tpu/train/checkpoint.py).  The port reads a JAX checkpoint in a
process where importing jax or optax fails, and the JAX Trainer reads the
port's; params and optimizer leaves must come out equal, bit for bit.  All
runs are on the thin model (nf=2, 8 latents, 21x25x21) on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from vaegam_tpu.data.device_cache import DeviceResidentLoader as JaxLoader
from vaegam_tpu.models import VAEGAMConfig as JaxConfig
from vaegam_tpu.train import Trainer as JaxTrainer

from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.train import Trainer, load_checkpoint
from vaegam_tpu_torch.train.checkpoint import flatten
from vaegam_tpu_torch.utils.jax_params import params_from_jax, params_to_jax
from vaegam_tpu_torch.utils.tree import tree_items

from torch_port_common import FULL, THIN, XU_RANGES, make_batch, make_model, to_np

ROOT = Path(__file__).resolve().parents[1]


def _data(n=8, seed=7):
    covs, vols = make_batch(THIN["img_shape"], n, seed=seed)
    return vols, covs


def _port_loader(shuffle=True):
    vols, covs = _data()
    return DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, shuffle=shuffle,
                                            seed=1, device="cpu")


def _port_trainer(tmp_path, seed=2, **kw):
    cfg = kw.pop("config", VAEGAMConfig(**THIN))
    rng = np.random.default_rng(6)
    glm = rng.normal(size=(cfg.img_dim, 9)).astype(np.float32)
    return Trainer(cfg, XU_RANGES, glm, save_dir=str(tmp_path), seed=seed,
                   device="cpu", **kw)


def _leaves_equal(got, want, what):
    got, want = flatten(got), flatten(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("cfg_kw", [THIN, FULL], ids=["thin", "full"])
def test_params_to_jax_inverts_params_from_jax(cfg_kw):
    """A permutation-and-flip round trip: bit for bit, consts included."""
    _, pc, params, consts, tp, tc = make_model(cfg_kw)
    back, back_c = params_to_jax(tp, tc, pc)
    want = to_np(params)
    assert [p for p, _ in tree_items(back)] == [p for p, _ in tree_items(want)]
    for (path, a), (_, b) in zip(tree_items(back), tree_items(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    for k, v in to_np(consts).items():
        np.testing.assert_array_equal(back_c[k], v, err_msg=k)
    again, _ = params_from_jax(back, None, pc)
    for (path, a), (_, b) in zip(tree_items(again), tree_items(tp)):
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX Trainer after one epoch (2 Adam steps), saved with save_state."""
    out = tmp_path_factory.mktemp("jax_ckpt")
    jc = JaxConfig(**THIN)
    glm = np.random.default_rng(6).normal(size=(jc.img_dim, 9)).astype(np.float32)
    t = JaxTrainer(jc, XU_RANGES, glm, save_dir=str(out), seed=3, enable_tb=False)
    vols, covs = _data()
    t.train_epoch(JaxLoader.from_arrays(vols, covs, batch_size=4, shuffle=True, seed=1))
    path = str(out / "checkpoint_001.tar")
    t.save_state(path)
    return path, t


def test_port_loads_jax_checkpoint_without_jax(jax_ckpt, tmp_path):
    """In a process where `import jax` and `import optax` fail: the port's
    Trainer loads the JAX checkpoint, and its params, Adam moments, counters
    and consts, mapped back to the JAX layout, equal the JAX Trainer's; the
    PRNG chain restart is printed."""
    path, jt = jax_ckpt
    out = tmp_path / "loaded.npz"
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['optax'] = sys.modules['vaegam_tpu'] = None\n"
        "import numpy as np\n"
        "from vaegam_tpu_torch.models import VAEGAMConfig\n"
        "from vaegam_tpu_torch.train import Trainer\n"
        "from vaegam_tpu_torch.utils.jax_params import params_to_jax\n"
        "from vaegam_tpu_torch.utils.tree import tree_items\n"
        f"t = Trainer(VAEGAMConfig(nf=2, num_latents=8, img_shape={THIN['img_shape']}), "
        "[[-1.0, 1.0]] * 6, device='cpu')\n"
        f"t.load_state({path!r})\n"
        "p, c = params_to_jax(t.params, t.consts, t.config)\n"
        "st = t.opt_state\n"
        "out = {'p/' + k: v for k, v in tree_items(p)}\n"
        "out.update({'c/' + k: v for k, v in c.items()})\n"
        "for m in ('mu', 'nu'):\n"
        "    out.update({m + '/' + k: v for k, v in tree_items(params_to_jax(st[m], None, t.config)[0])})\n"
        "for k in ('notfinite_count', 'last_finite', 'total_notfinite', 'count'):\n"
        "    out[k] = st[k].numpy()\n"
        "out['epoch'] = np.asarray(t.epoch)\n"
        f"np.savez({str(out)!r}, **out)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PRNG chain restarts" in proc.stdout
    got = np.load(out)
    assert int(got["epoch"]) == jt.epoch == 1
    for path_, v in tree_items(to_np(jt.params)):
        np.testing.assert_array_equal(got["p/" + path_], v, err_msg=path_)
    for k, v in to_np(jt.consts).items():
        np.testing.assert_array_equal(got["c/" + k], v, err_msg=k)
    st = jt.opt_state
    adam = st.inner_state[0]
    for m in ("mu", "nu"):
        for path_, v in tree_items(to_np(getattr(adam, m))):
            np.testing.assert_array_equal(got[f"{m}/{path_}"], v, err_msg=f"{m} {path_}")
    for k in ("notfinite_count", "last_finite", "total_notfinite"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(st, k)), err_msg=k)
    assert int(got["count"]) == int(adam.count) == 2


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["adam", "clip"])
def test_jax_loads_port_checkpoint(tmp_path, clip):
    """The JAX Trainer's load_state accepts the port's checkpoint: its params,
    consts and every optimizer leaf (apply_if_finite counters, Adam count,
    mu, nu) equal the port's, mapped to the JAX layout."""
    t = _port_trainer(tmp_path, grad_clip=clip)
    t.train_epoch(_port_loader())
    path = str(tmp_path / "port.tar")
    t.save_state(path)
    jt = JaxTrainer(JaxConfig(**THIN), XU_RANGES, None, save_dir=str(tmp_path),
                    enable_tb=False, grad_clip=clip)
    jt.load_state(path)
    assert jt.epoch == 1 and jt.loss == t.loss
    want_p, want_c = params_to_jax(t.params, t.consts, t.config)
    _leaves_equal(to_np(jt.params), want_p, "params")
    _leaves_equal(to_np(jt.consts), want_c, "consts")
    _leaves_equal(jax.tree_util.tree_leaves(to_np(jt.opt_state)),
                  t._opt_state_to_jax(), "optimizer")
    assert int(jt.opt_state.inner_state[-1][0].count if clip else
               jt.opt_state.inner_state[0].count) == 2


def test_resume_is_bitwise_within_the_port(tmp_path):
    """2 epochs, save, a fresh Trainer (another seed) loads, 1 epoch: the
    params, optimizer state, generator and loss history equal 3 unbroken
    epochs bit for bit."""
    unbroken = _port_trainer(tmp_path)
    loader = _port_loader()
    for _ in range(3):
        unbroken.loss["train"][unbroken.epoch] = unbroken.train_epoch(loader)

    first = _port_trainer(tmp_path)
    for _ in range(2):
        first.loss["train"][first.epoch] = first.train_epoch(loader)
    path = str(tmp_path / "resume.tar")
    first.save_state(path)
    resumed = _port_trainer(tmp_path, seed=99)
    resumed.load_state(path)
    assert resumed.epoch == 2
    resumed.loss["train"][resumed.epoch] = resumed.train_epoch(loader)

    assert resumed.loss == unbroken.loss
    for (path_, a), (_, b) in zip(tree_items(resumed.params), tree_items(unbroken.params)):
        assert torch.equal(a, b), path_
    for k in ("mu", "nu"):
        for (path_, a), (_, b) in zip(tree_items(resumed.opt_state[k]),
                                      tree_items(unbroken.opt_state[k])):
            assert torch.equal(a, b), f"{k} {path_}"
    for k in ("count", "notfinite_count", "last_finite", "total_notfinite"):
        assert torch.equal(resumed.opt_state[k], unbroken.opt_state[k]), k
    assert torch.equal(resumed.generator.get_state(), unbroken.generator.get_state())


def test_checkpoint_file_format(tmp_path):
    """The JAX format's keys, params in the JAX layout, the generator state
    under its own key, and no leftover .tmp file."""
    t = _port_trainer(tmp_path)
    path = str(tmp_path / "fmt.tar")
    t.save_state(path)
    state = load_checkpoint(path, expect_z_dim=t.config.z_dim)
    assert set(state) >= {"format_version", "params", "optimizer_state", "loss", "z_dim",
                          "epoch", "lr", "save_dir", "glm_reg_scale", "gp_kl_scale",
                          "inducing_pts", "consts", "rng_key"}
    assert state["rng_key"] is None and state["torch_rng_state"]["device"] == "cpu"
    assert state["params"]["enc"]["conv1"]["w"].shape == (3, 3, 3, 1, 2)  # DHWIO
    assert not os.path.exists(path + ".tmp")


def test_z_dim_mismatch_is_refused(tmp_path):
    t = _port_trainer(tmp_path)
    path = str(tmp_path / "z.tar")
    t.save_state(path)
    other = _port_trainer(tmp_path, config=VAEGAMConfig(**dict(THIN, num_latents=16)))
    with pytest.raises(ValueError, match="z_dim"):
        other.load_state(path)


def test_load_state_adopts_checkpoint_scalars(tmp_path, capsys):
    t = _port_trainer(tmp_path, lr=1e-3)
    path = str(tmp_path / "scalars.tar")
    t.save_state(path)
    other = _port_trainer(tmp_path, lr=5e-4, config=VAEGAMConfig(
        **dict(THIN, gp_kl_scale=99.0, glm_reg_scale=7.0)))
    capsys.readouterr()
    other.load_state(path)
    out = capsys.readouterr().out
    assert "adopting checkpoint scalars" in out and "adopting checkpoint lr" in out
    assert (other.config.gp_kl_scale, other.config.glm_reg_scale, other.lr) == (10.0, 1.0, 1e-3)
    same = _port_trainer(tmp_path, lr=1e-3)
    capsys.readouterr()
    same.load_state(path)
    assert "adopting" not in capsys.readouterr().out


def test_optimizer_structure_mismatch_restarts_adam(tmp_path, capsys):
    """A checkpoint written with the non-finite guard loaded by a Trainer
    without it: the leaves do not fit, Adam restarts, params still load."""
    t = _port_trainer(tmp_path)
    t.train_epoch(_port_loader())
    path = str(tmp_path / "guard.tar")
    t.save_state(path)
    other = _port_trainer(tmp_path, skip_nonfinite_updates=False)
    other.load_state(path)
    assert "structure mismatch" in capsys.readouterr().out
    assert int(other.opt_state["count"]) == 0
    assert all(float(m.abs().max()) == 0 for _, m in tree_items(other.opt_state["mu"]))
    for (path_, a), (_, b) in zip(tree_items(other.params), tree_items(t.params)):
        assert torch.equal(a, b), path_


def _roundtrip_through_jax(tmp_path, port_cfg, jax_cfg, reader_cfg):
    """The port trains one epoch under `port_cfg` and saves; a JAX Trainer
    under `jax_cfg` loads that checkpoint and saves it again; a port
    Trainer under `reader_cfg` loads the JAX one.  Returns (writer, JAX
    trainer, reader)."""
    t = _port_trainer(tmp_path, config=VAEGAMConfig(**dict(THIN, **port_cfg)))
    t.train_epoch(_port_loader())
    path = str(tmp_path / "port.tar")
    t.save_state(path)
    jt = JaxTrainer(JaxConfig(**dict(THIN, **jax_cfg)), XU_RANGES, None,
                    save_dir=str(tmp_path), enable_tb=False)
    jt.load_state(path)
    want_p, _ = params_to_jax(t.params, t.consts, t.config)
    _leaves_equal(to_np(jt.params), want_p, "params")
    _leaves_equal(jax.tree_util.tree_leaves(to_np(jt.opt_state)), t._opt_state_to_jax(),
                  "optimizer")
    back_path = str(tmp_path / "jax.tar")
    jt.save_state(back_path)
    reader = _port_trainer(tmp_path, seed=5, config=VAEGAMConfig(**dict(THIN, **reader_cfg)))
    reader.load_state(back_path)
    for (path_, a), (_, b) in zip(tree_items(reader.params), tree_items(t.params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path_
    for k in ("mu", "nu"):
        for (path_, a), (_, b) in zip(tree_items(reader.opt_state[k]),
                                      tree_items(t.opt_state[k])):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{k} {path_}"
    return t, jt, reader


@pytest.mark.parametrize("reader_cholesky", [True, False], ids=["cholesky", "raw"])
def test_cholesky_checkpoint_both_ways(tmp_path, reader_cholesky):
    """qu_S_raw crosses both ways with equal params and Adam moments, bit for
    bit.  The checkpoint's parameterization wins over the config's, as in
    the JAX Trainer (its params are taken as saved and Adam's state is
    shaped from them): a JAX Trainer built without qu_s_cholesky and a port
    Trainer with either setting hold qu_S_raw after loading, and the
    port's trains on from it."""
    _, jt, reader = _roundtrip_through_jax(tmp_path, {"qu_s_cholesky": True}, {},
                                           {"qu_s_cholesky": reader_cholesky})
    assert "qu_S_raw" in jt.params["gp"] and "qu_S" not in jt.params["gp"]
    assert "qu_S_raw" in reader.params["gp"] and "qu_S" not in reader.params["gp"]
    assert int(reader.opt_state["count"]) == 2
    assert np.isfinite(reader.train_epoch(_port_loader()))
    assert int(reader.opt_state["count"]) == 4


def test_x64_epsilon_checkpoint_both_ways(tmp_path):
    """A float64 epsilon and its float64 Adam moments stay float64 and equal
    through the port's checkpoint into the JAX Trainer (under x64) and
    through the JAX Trainer's checkpoint back into the port."""
    with jax.enable_x64(True):
        _, jt, reader = _roundtrip_through_jax(tmp_path, {"x64_epsilon": True},
                                               {"x64_epsilon": True}, {"x64_epsilon": True})
        assert jt.params["epsilon"].dtype == np.float64
        adam = jt.opt_state.inner_state[0]
        assert adam.mu["epsilon"].dtype == adam.nu["epsilon"].dtype == np.float64
        assert jt.params["enc"]["conv1"]["w"].dtype == np.float32
    assert reader.params["epsilon"].dtype == torch.float64
    assert reader.opt_state["nu"]["epsilon"].dtype == torch.float64
    assert float(reader.opt_state["nu"]["epsilon"].abs().max()) > 0
