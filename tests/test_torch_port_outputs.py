"""The port's output stage against the JAX package's.

The GP marginal posterior, the wide eval view, the NIfTI writers (byte for
byte, both wires, both writers), the latent encode, the GP CSVs, the
Trainer's TensorBoard tags, and the train CLI with its output stage on the
CPU.  Thin model (nf=2, 8 latents, 21x25x21) on a 2-subject x 8-volume tree
from tests/e2e_helpers.py.
"""

import dataclasses
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import vaegam_tpu.utils.nifti_native as jax_nifti_native
from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.data import setup_data_loaders as jax_setup_data_loaders
from vaegam_tpu.models import VAEGAMConfig as JaxConfig
from vaegam_tpu.models import gp as jax_gp
from vaegam_tpu.models.vaegam import MAP_KEYS
from vaegam_tpu.outputs import gp_plots as jax_gp_plots
from vaegam_tpu.outputs import latents as jax_latents
from vaegam_tpu.outputs import recons as jax_recons
from vaegam_tpu.train import Trainer as JaxTrainer

import vaegam_tpu_torch.cli.train as cli
import vaegam_tpu_torch.utils.nifti_native as port_nifti_native
from vaegam_tpu_torch.data import (DataLoader, DeviceResidentLoader, FMRIDataset,
                                   setup_data_loaders, wide_eval_view)
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.models import gp as port_gp
from vaegam_tpu_torch.outputs import gp_plots, latents, recons
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils import nifti

from torch_port_common import (THIN, XU_RANGES, f64_jax, f64_port, jax_float64,
                               make_model, to_np)

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """(design csv, GLM-maps csv): 2 subjects x 8 volumes, small grid."""
    root = str(tmp_path_factory.mktemp("subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=8, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    glm = os.path.join(root, "glm.csv")
    rng = np.random.default_rng(0)
    pd.DataFrame(rng.normal(size=(int(np.prod(SMALL_SHAPE)), 8))).to_csv(glm)
    return csv, glm


@pytest.fixture(scope="module")
def model():
    return make_model(THIN, glm=False)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dp, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# GP marginal posterior
# ---------------------------------------------------------------------------

def test_evaluate_posterior_diag_matches_jax_and_the_dense_diagonal():
    """Float64, 6 stacked GPs over 50 query rows: f_bar and var equal the
    JAX function's per GP (rtol 1e-10) and the diagonal of the port's dense
    evaluate_posterior."""
    rng = np.random.default_rng(4)
    g, p, n = 6, 6, 50
    xu = np.stack([np.linspace(-3 - i / 10, 3 + i / 10, p) for i in range(g)])
    kvar, ls = rng.uniform(0.5, 2.0, g), rng.uniform(0.8, 2.0, g)
    qu_m = rng.normal(size=(g, p))
    a = rng.normal(size=(g, p, p))
    qu_S = a @ a.transpose(0, 2, 1) / p + np.eye(p)
    xq = rng.normal(size=(g, n))
    args = [torch.tensor(v) for v in (xu, kvar, ls, qu_m, qu_S, xq)]
    f_bar, var = port_gp.evaluate_posterior_diag(*args)
    dense_f, sigma = port_gp.evaluate_posterior(*args)
    np.testing.assert_allclose(f_bar, dense_f, rtol=1e-10)
    np.testing.assert_allclose(var, torch.diagonal(sigma, dim1=-2, dim2=-1), rtol=1e-10)
    with jax.enable_x64(True):
        for j in range(g):
            jf, jv = jax_gp.evaluate_posterior_diag(
                *(jnp.asarray(v[j]) for v in (xu, kvar, ls, qu_m, qu_S, xq)))
            np.testing.assert_allclose(f_bar[j].numpy(), np.asarray(jf), rtol=1e-10)
            np.testing.assert_allclose(var[j].numpy(), np.asarray(jv), rtol=1e-10)


# ---------------------------------------------------------------------------
# wide eval view
# ---------------------------------------------------------------------------

def test_wide_eval_view(study):
    """Same samples in the same order at the wider width; the device cache
    is shared (no second upload); the width is capped by the budget of two
    10 x B x img_dim fp32 map blocks, and a width at or under the loader's
    returns the loader itself."""
    csv, _ = study
    ds = FMRIDataset(csv)
    img_dim = int(np.prod(SMALL_SHAPE))
    for loader in (DataLoader(ds, batch_size=4),
                   DeviceResidentLoader(ds, batch_size=4, device="cpu")):
        wide = wide_eval_view(loader, img_dim, width=8)
        assert wide.batch_size == 8 and not wide.shuffle and len(wide) == 2
        for field in ("volume", "subjid", "vol_num"):
            base = np.concatenate([np.asarray(b[field]) for b in loader])
            got = np.concatenate([np.asarray(b[field]) for b in wide])
            np.testing.assert_array_equal(base, got)
        if isinstance(loader, DeviceResidentLoader):
            assert wide.vols is loader.vols and wide.covs is loader.covs
        assert wide_eval_view(loader, img_dim, width=4) is loader
    capped = wide_eval_view(DataLoader(ds, batch_size=4), img_dim, width=128,
                            max_map_bytes=2 * 10 * img_dim * 4 * 5)
    assert capped.batch_size == 5
    # at the reference grid the 1.5 GiB budget allows 286 rows
    assert wide_eval_view(DataLoader(ds, batch_size=4), 41 * 49 * 35,
                          width=1024).batch_size == 286


# ---------------------------------------------------------------------------
# NIfTI writers, byte for byte
# ---------------------------------------------------------------------------

def _fake_maps(x, wire):
    """Seeded-by-content maps of one batch: (B, img_dim) per key, spanning
    about +-5 like gain-scaled motion maps."""
    flat = np.asarray(x, np.float32).reshape(len(x), -1)
    maps = {k: ((flat - 0.3) * (j - 4.5) * 2.0).astype(np.float32)
            for j, k in enumerate(MAP_KEYS)}
    return {k: v.astype(wire) for k, v in maps.items()}


@pytest.mark.parametrize("writer", ["native", "python"])
@pytest.mark.parametrize("wire", ["float32", "float16"])
def test_recon_writers_byte_identical_to_jax(study, tmp_path, monkeypatch, writer, wire):
    """The same maps through JAX's reconstruct + mk_avg_maps and the port's
    (each Trainer's maps step replaced on the instance) give identical
    trees, names and bytes.  Batch 3 over 2 x 8 volumes: batches straddle
    the subjects and the tail batch is short."""
    csv, _ = study
    if writer == "native":
        if not port_nifti_native.writer_available():
            subprocess.run(["make", "-C", NATIVE_DIR], check=False)
        if not (port_nifti_native.writer_available()
                and jax_nifti_native.writer_available()):
            pytest.skip("the native writer is not built and did not build")
    else:
        monkeypatch.setattr(jax_nifti_native, "writer_available", lambda: False)
        monkeypatch.setattr(port_nifti_native, "writer_available", lambda: False)

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(**THIN), XU_RANGES, save_dir=str(jdir), enable_tb=False)
    jt.epoch = 7
    jt._recon_maps_step = lambda: (lambda p, key, covs, x: (None, {"maps": {
        k: jnp.asarray(v) for k, v in _fake_maps(x, wire).items()}}))
    jax_loader = jax_setup_data_loaders(batch_size=3, train_csv=csv,
                                        test_csv=csv)["UnShuffled_train"]
    jax_recons.mk_single_volumes(jax_loader, jt, csv, str(jdir))
    jax_recons.mk_avg_maps(csv, jt, str(jdir), mk_motion_maps=True)

    pt = Trainer(VAEGAMConfig(**THIN), XU_RANGES, save_dir=str(pdir), enable_tb=False,
                 device="cpu")
    pt.epoch = 7
    pt.recon_maps_step = lambda covs, x: (None, {"maps": {
        k: torch.from_numpy(v) for k, v in _fake_maps(x.numpy(), wire).items()}})
    loader = setup_data_loaders(batch_size=3, train_csv=csv,
                                test_csv=csv)["UnShuffled_train"]
    recons.mk_single_volumes(loader, pt, csv, str(pdir))
    recons.mk_avg_maps(csv, pt, str(pdir), mk_motion_maps=True)

    want, got = _tree(jdir / "reconstructions"), _tree(pdir / "reconstructions")
    assert len(want) == 16 * 10 + 3 * 10
    assert sorted(got) == sorted(want)
    assert [p for p in want if got[p] != want[p]] == []
    assert pt.output_stats["recons"]["volumes"] == 16
    vol = nifti.load(str(pdir / "reconstructions" / "007_model_recons" /
                          "sub-A00050" / "vol_0" / "recon_task.nii"))
    assert vol.shape == SMALL_SHAPE and vol.dataobj.dtype == np.float32


@pytest.mark.parametrize("writer", ["native", "python"])
def test_writers_read_the_host_arrays_after_submit(study, tmp_path, monkeypatch, writer):
    """Both writers read the maps' host arrays on their own threads after
    ``submit`` returns (the Python pool makes its float32 copy there too),
    which is why a host buffer set waits for its writes: a refill while the
    writer thread is held shows in the file."""
    csv, _ = study
    if writer == "native":
        if not port_nifti_native.writer_available():
            subprocess.run(["make", "-C", NATIVE_DIR], check=False)
        if not port_nifti_native.writer_available():
            pytest.skip("the native writer is not built and did not build")
    else:
        monkeypatch.setattr(port_nifti_native, "writer_available", lambda: False)
        monkeypatch.setattr(recons, "_WRITER_THREADS", 1)
    refs = pd.read_csv(csv).nii_path.unique().tolist()
    w = recons._Writer(refs, [str(tmp_path / "s0"), str(tmp_path / "s1")], SMALL_SHAPE)
    buf = np.zeros((len(MAP_KEYS), 2, int(np.prod(SMALL_SHAPE))), np.float32)
    gate = threading.Event()
    with w.pool:
        w.pool.submit(gate.wait, 10)  # holds the pool's one thread
        futures = w.submit({"subjid": np.array([0, 0]), "vol_num": np.array([0, 1])},
                           {k: buf[j] for j, k in enumerate(MAP_KEYS)})
        buf[:] = 1.0
        gate.set()
        for f in futures:
            f.result()
    got = nifti.load(str(tmp_path / "s0" / "vol_1" / "recon_task.nii")).dataobj
    assert (np.asarray(got) == 1.0).all()


def test_host_buffers_wait_for_their_writes():
    """A buffer set is handed out again only after every write future of
    the batch that used it is done."""
    gate = threading.Event()
    with ThreadPoolExecutor(1) as pool:
        bufs = recons._HostBuffers(2, 5, torch.float32, pin=False)
        held = [bufs.claim() for _ in range(recons._HOST_BUFFERS)]
        slow = pool.submit(gate.wait, 10)
        bufs.release(held[0], [slow])
        for b in held[1:]:
            bufs.release(b, [])
        threading.Timer(0.2, gate.set).start()
        again = bufs.claim()
        assert slow.done() and again is held[0]
        bufs.drain()


# ---------------------------------------------------------------------------
# latents and GP CSVs
# ---------------------------------------------------------------------------

def test_project_latent_matches_jax_in_float64(study, model, tmp_path):
    """Shared weights, both sides in float64: the posterior means of every
    volume agree to rtol 1e-6; 16 rows take the PCA stand-in on both."""
    csv, _ = study
    jc, pc, params, consts, tp, tc = model
    jt = JaxTrainer(jc, XU_RANGES, save_dir=str(tmp_path / "jax"), enable_tb=False)
    with jax_float64():
        jt.config = dataclasses.replace(jc, dtype=jnp.float64)
        jt.params = f64_jax(to_np(params))
        want, _ = jax_latents.project_latent(
            jt, jax_setup_data_loaders(batch_size=3, train_csv=csv, test_csv=csv),
            str(tmp_path / "jax"), split=8)
    pt = Trainer(pc, save_dir=str(tmp_path / "port"), enable_tb=False,
                 device="cpu", params=f64_port(tp), consts=f64_port(tc))
    batches = [dict(b, volume=torch.from_numpy(b["volume"]).double())
               for b in setup_data_loaders(batch_size=3, train_csv=csv,
                                           test_csv=csv)["UnShuffled_train"]]
    got, proj, backend = latents.project_latent(
        pt, {"UnShuffled_train": batches}, str(tmp_path / "port"), split=8)
    assert got.dtype == np.float64 and got.shape == (16, THIN["num_latents"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert backend == "pca" and proj.shape == (16, 2)
    assert os.path.exists(tmp_path / "port" / "000_temp.pdf")
    assert {"latent_encode_s", "umap_s", "latent_plot_s"} <= set(pt.output_stats)


def test_plot_gps_csvs_match_jax(study, model, tmp_path):
    """Shared GP parameters, both sides in float64: the same 6 CSVs with
    the same rows (sorted by xq), mean and vars rtol 1e-6; the 6 PDFs are
    written."""
    csv, _ = study
    jc, pc, params, consts, tp, tc = model
    jt = JaxTrainer(jc, XU_RANGES, save_dir=str(tmp_path / "jax"), enable_tb=False)
    pt = Trainer(pc, save_dir=str(tmp_path / "port"), enable_tb=False,
                 device="cpu", params=f64_port(tp), consts=f64_port(tc))
    jt.epoch = pt.epoch = 5
    with jax.enable_x64(True):
        jt.config = dataclasses.replace(jc, dtype=jnp.float64)
        jt.params, jt.consts = f64_jax(to_np(params)), f64_jax(to_np(consts))
        jax_gp_plots.plot_GPs(jt, csv_file=csv, save_dir=str(tmp_path / "jax"))
    gp_plots.plot_GPs(pt, csv_file=csv, save_dir=str(tmp_path / "port"))
    jdir, pdir = tmp_path / "jax" / "005_GP_plots", tmp_path / "port" / "005_GP_plots"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    names = [f for f in os.listdir(pdir) if f.endswith(".csv")]
    assert len(names) == 6 and sum(f.endswith(".pdf") for f in os.listdir(pdir)) == 6
    for name in names:
        got, want = pd.read_csv(pdir / name), pd.read_csv(jdir / name)
        assert list(got.columns) == list(want.columns) and len(got) == 16
        np.testing.assert_array_equal(got.iloc[:, 0], want.iloc[:, 0])
        np.testing.assert_array_equal(got["xq"], want["xq"])
        assert (np.diff(got["xq"]) >= 0).all()
        for col in ("mean", "vars"):
            np.testing.assert_allclose(got[col].to_numpy(np.float64),
                                       want[col].to_numpy(np.float64), rtol=1e-6)


# ---------------------------------------------------------------------------
# TensorBoard
# ---------------------------------------------------------------------------

def _tb_tags(save_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    run = os.path.join(save_dir, "run")
    (day,) = os.listdir(run)
    acc = EventAccumulator(os.path.join(run, day))
    acc.Reload()
    tags = acc.Tags()
    return sorted(tags["scalars"]), sorted(tags["images"])


def test_trainer_tensorboard_tags_match_jax(study, tmp_path):
    """One epoch, batch 4, figures every 2 batches, host loaders: the port
    writes the tags the JAX Trainer writes (Loss/Train, q(u)_train,
    q(k)_train, Beta/{cov}_train, the map slices) under run/<date>."""
    csv, _ = study
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(**THIN), XU_RANGES, save_dir=str(jdir),
                    log_figs_every=2)
    jt.train_loop(jax_setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv),
                  epochs=1, test_freq=None, save_freq=None)
    pt = Trainer(VAEGAMConfig(**THIN), XU_RANGES, save_dir=str(pdir), log_figs_every=2,
                 device="cpu")
    pt.train_loop(setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv),
                  epochs=1, test_freq=None, save_freq=None)
    jt.writer.close()  # tensorboardX's flush can leave the last event queued
    pt.writer.close()
    want, got = _tb_tags(str(jdir)), _tb_tags(str(pdir))
    assert got == want
    scalars, images = got
    assert scalars == ["Loss/Train"]
    assert {"q_u__train", "q_k__train", "Beta/task_train", "base_map_train_12/0",
            "full_reconstruction_train_18/3"} <= set(images)
    assert sorted(pt.tb_seconds) == [0]


# ---------------------------------------------------------------------------
# the CLI with its output stage
# ---------------------------------------------------------------------------

def _argv(study, save_dir, *extra):
    csv, glm = study
    return ["--train_csv", csv, "--test_csv", csv, "--glm_maps", glm,
            "--save_dir", str(save_dir), "--batch-size", "4", "--nf", "2",
            "--num_latents", "8", "--img_shape", *map(str, SMALL_SHAPE),
            "--split", "8", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_run(study, tmp_path_factory):
    """2 epochs through the CLI without --no_outputs."""
    out = tmp_path_factory.mktemp("cli_run")
    trainer, _ = cli.main(_argv(study, out, "--epochs", "2", "--save_freq", "1",
                                "--test_freq", "1"))
    return out, trainer


def _check_outputs(out, prefix):
    recon_dir = out / "reconstructions" / f"{prefix}_model_recons"
    subjs = sorted(os.listdir(recon_dir))
    assert subjs == ["sub-A00050", "sub-A00051"]
    for s in subjs:
        vols = sorted(os.listdir(recon_dir / s))
        assert vols == sorted(f"vol_{v}" for v in range(8))
        for v in vols:
            assert sorted(os.listdir(recon_dir / s / v)) == sorted(
                f"recon_{k}.nii" for k in MAP_KEYS)
    avg_dir = out / "reconstructions" / f"{prefix}_avg_model_recons"
    for d in (avg_dir, avg_dir / subjs[0], avg_dir / subjs[1]):
        assert sorted(f for f in os.listdir(d) if f.endswith(".nii")) == sorted(
            f"{k}_avg.nii" for k in MAP_KEYS)
    img = nifti.load(str(recon_dir / subjs[0] / "vol_0" / "recon_base.nii"))
    assert img.shape == SMALL_SHAPE and np.isfinite(np.asarray(img.dataobj)).all()


def test_cli_runs_the_output_stage(cli_run):
    """The file tree tests/test_e2e_cli.py:82-109 asserts for the JAX CLI:
    checkpoint_001.tar, 002_temp.pdf, 6 GP CSVs and 6 PDFs, 10 recon files
    per volume, subject and grand averages, and a TensorBoard run."""
    out, trainer = cli_run
    assert (out / "checkpoint_001.tar").exists()
    assert (out / "002_temp.pdf").exists()
    files = os.listdir(out / "002_GP_plots")
    assert sum(f.endswith(".csv") for f in files) == 6
    assert sum(f.endswith(".pdf") for f in files) == 6
    _check_outputs(out, "002")
    (day,) = os.listdir(out / "run")
    assert any("tfevents" in f for f in os.listdir(out / "run" / day))
    stats = trainer.output_stats
    assert stats["recons"]["volumes"] == 16 and stats["umap_backend"] == "pca"
    assert {"latent_encode_s", "gp_plots_s", "avg_maps_s"} <= set(stats)


def test_cli_recons_only_from_checkpoint(study, cli_run, tmp_path):
    """--recons_only --from_ckpt runs the output stage without training,
    at the checkpoint's post-increment epoch."""
    out, _ = cli_run
    trainer, _ = cli.main(_argv(study, tmp_path, "--from_ckpt", "--ckpt_path",
                                str(out / "checkpoint_001.tar"), "--recons_only"))
    assert trainer.epoch == 2 and sorted(trainer.loss["train"]) == [0, 1]
    assert not any(f.endswith(".tar") for f in os.listdir(tmp_path))
    _check_outputs(tmp_path, "002")


def test_cli_float16_wire_and_wide_eval(study, cli_run, tmp_path, monkeypatch):
    """--recon_wire_dtype float16 --eval_batch_size 16: one 16-row batch of
    float16 maps, float32 files."""
    out, _ = cli_run
    widths = []
    orig = cli.mk_single_volumes

    def spy(loader, trainer, *args):
        widths.append(loader.batch_size)
        return orig(loader, trainer, *args)

    monkeypatch.setattr(cli, "mk_single_volumes", spy)
    trainer, _ = cli.main(_argv(study, tmp_path, "--from_ckpt", "--ckpt_path",
                                str(out / "checkpoint_001.tar"), "--recons_only",
                                "--recon_wire_dtype", "float16",
                                "--eval_batch_size", "16"))
    assert widths == [16]
    _, aux = trainer.recon_maps_step(torch.zeros(2, 8), torch.rand((2,) + SMALL_SHAPE))
    assert all(v.dtype == torch.float16 for v in aux["maps"].values())
    _check_outputs(tmp_path, "002")
    with pytest.raises(ValueError, match="recon_wire_dtype"):
        Trainer(VAEGAMConfig(**THIN), XU_RANGES, device="cpu",
                recon_wire_dtype="bfloat16")
