"""The port's correctness oracle and the host CLIs it drives, against the
JAX package: the stimulus series, build_fake_subjects and the ground-truth
maps, add_signal and preproc (byte-identical files), beta_maps, the oracle's
Trainer inputs and recovery metrics, and the oracle end to end on the CPU
at a small size.  Everything runs on the CPU (``--device cpu``).
"""

import ast
import contextlib
import gzip
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from test_beta_maps_cli import DIMS, feat_tree  # noqa: F401  (the fixture)
from vaegam_tpu.cli import add_signal as jax_add_signal
from vaegam_tpu.cli import beta_maps as jax_beta_maps
from vaegam_tpu.cli import preproc as jax_preproc
from vaegam_tpu.tools import control_experiment as jax_ce
from vaegam_tpu.utils import signals as jax_signals

from vaegam_tpu_torch.cli import add_signal, beta_maps, preproc
from vaegam_tpu_torch.tools import control_experiment as ce
from vaegam_tpu_torch.utils import signals

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (21, 25, 21)
MOTION_SHAPE = (31, 37, 27)   # the smallest-ish grid the motion maps fit
REF_GRID = (41, 49, 35)
N_VOLS = 12


def _payload(path: Path) -> bytes:
    """A file's bytes; for .gz the bytes inside the container (its header
    carries a time stamp)."""
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


def _assert_same_tree(a: Path, b: Path, mapped=()):
    """Same relative file names and the same payloads; in text files each
    (old, new) of `mapped` is replaced in a's bytes first."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert names
    for n in names:
        want = _payload(a / n)
        for old, new in mapped:
            want = want.replace(old.encode(), new.encode())
        assert _payload(b / n) == want, n


# ---------------------------------------------------------------------------
# stimulus series, ground-truth maps, fake subjects
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [12, 98, 294])
def test_stimulus_series_match_jax(n):
    """Both block series at TR 1.4 s (and at a few off-grid times): equal
    values, int64 like JAX's."""
    times = np.concatenate([np.arange(1, n + 1) * 1.4, [0.0, 19.99, 20.0, 39.9, 40.0]])
    for name in ("stimulus_to_neural", "control_stimulus_to_neural"):
        got, want = getattr(signals, name)(times), getattr(jax_signals, name)(times)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(signals.control_stimulus_to_neural(times),
                                  1 - signals.stimulus_to_neural(times))


@pytest.mark.parametrize("shape", [MOTION_SHAPE, REF_GRID, (91, 109, 91)])
def test_motion_and_sex_maps_match_jax(shape):
    for name in ("build_motion_maps", "build_sex_map"):
        got, want = getattr(ce, name)(shape), getattr(jax_ce, name)(shape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def fake_trees(tmp_path_factory):
    """build_fake_subjects of both packages on the same arguments: 2
    subjects x 12 volumes at 21x25x21 with a sex effect (the motion maps
    do not fit that grid in either package).  Returns the root."""
    root = tmp_path_factory.mktemp("fake")
    kw = dict(n_subjs=2, n_vols=N_VOLS, seed=0, sex_effect_intensity=200.0,
              img_shape=SHAPE)
    assert jax_ce.build_fake_subjects(str(root / "jax"), **kw) is None
    assert ce.build_fake_subjects(str(root / "port"), **kw) is None
    return root


def test_build_fake_subjects_matches_jax(fake_trees, tmp_path):
    """The same NIfTI payloads, motion TSVs and sex CSV, byte for byte: at
    21x25x21 with a sex effect, and at 31x37x27 with motion artifacts, a
    sex effect and shared anatomy, where the injected motion maps are
    equal too."""
    _assert_same_tree(fake_trees / "jax", fake_trees / "port")
    kw = dict(n_subjs=2, n_vols=4, seed=3, motion_artifact_intensity=150.0,
              sex_effect_intensity=200.0, noise_sigma=20.0, anatomy_var=0.3,
              img_shape=MOTION_SHAPE)
    want = jax_ce.build_fake_subjects(str(tmp_path / "jax"), **kw)
    got = ce.build_fake_subjects(str(tmp_path / "port"), **kw)
    assert got.shape == (6,) + MOTION_SHAPE
    np.testing.assert_array_equal(got, want)
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


# ---------------------------------------------------------------------------
# add_signal and preproc
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grid_tree(tmp_path_factory):
    """One subject x 3 volumes at the reference grid (the '3' stencil's
    insert is fixed to that grid)."""
    root = tmp_path_factory.mktemp("ref_grid")
    jax_ce.build_fake_subjects(str(root), 1, 3, img_shape=REF_GRID)
    return root


@pytest.mark.parametrize("case", ["simple", "three", "stencil_file", "name_quirk"])
def test_add_signal_matches_jax(case, fake_trees, ref_grid_tree, tmp_path):
    """Each package injects into its own copy of one tree: the same file
    names and byte-identical altered volumes, for the four spheres (scaled
    to 21x25x21, clip-safe), the embedded '3', a --stencil_file mask, and a
    source named *_zing.nii.gz, which rstrip(".nii.gz") cuts to *_ (it
    strips a character set, not the suffix)."""
    src, shape = ((fake_trees / "jax", SHAPE) if case in ("simple", "name_quirk")
                  else (ref_grid_tree, REF_GRID))
    argv = ["--intensity", "400", "--img_shape", *map(str, shape)]
    if case in ("three", "stencil_file"):
        argv += ["--shape", "three"]
    if case == "stencil_file":
        stencil = (np.random.default_rng(5).uniform(size=(13, 13)) > 0.6).astype(np.float64)
        np.save(tmp_path / "stencil.npy", stencil)
        argv += ["--stencil_file", str(tmp_path / "stencil.npy")]
    if case == "name_quirk":
        argv += ["--nii_file_pattern", "*_zing.nii.gz"]
    written = {}
    for name, mod in (("jax", jax_add_signal), ("port", add_signal)):
        shutil.copytree(src, tmp_path / name)
        if case == "name_quirk":
            for p in (tmp_path / name).rglob("*_resampled.nii.gz"):
                p.rename(p.with_name(p.name.replace("_resampled", "_zing")))
        written[name] = mod.main(["--root_dir", str(tmp_path / name), *argv])
    if case == "name_quirk":
        assert all(Path(p).name.startswith(Path(p).parent.name + "_preproc_bold_brainmasked"
                                           "__ALTERED_simple_400_simple_ts_")
                   for p in written["port"])
    assert [os.path.relpath(p, tmp_path / "port") for p in written["port"]] == \
        [os.path.relpath(p, tmp_path / "jax") for p in written["jax"]]
    assert written["port"] and all("_ALTERED_" in p for p in written["port"])
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")
    # the altered volumes differ from the source where the signal went in
    alt = np.asarray(add_signal.nifti.load(written["port"][0]).dataobj)
    src_nii = [p for p in sorted((tmp_path / "port").rglob("*.nii.gz"))
               if "_ALTERED_" not in p.name][0]
    assert np.abs(alt - np.asarray(add_signal.nifti.load(str(src_nii)).dataobj)).max() > 100


@pytest.mark.parametrize("control", [True, False], ids=["control", "checker"])
def test_preproc_matches_jax(control, fake_trees, tmp_path):
    """On the altered tree: the same date-stamped CSV name and the same
    bytes once the nii_path column's root is mapped (index column, task
    series, population z-score, sex)."""
    shutil.copytree(fake_trees / "jax", tmp_path / "data")
    add_signal.main(["--root_dir", str(tmp_path / "data"), "--intensity", "400",
                     "--img_shape", *map(str, SHAPE)])
    shutil.copytree(tmp_path / "data", tmp_path / "data_jax")
    argv = ["--set_tag", "TRAIN", "--nii_file_pattern", "*_ALTERED_simple_*.nii.gz",
            "--sex_info", "SEX", "--mot_file_pattern",
            "sub-A000*_desc-confounds_regressors_*.tsv"]
    if control:
        argv += ["--control", "--control_int", "400"]
    out = {}
    for name, mod, data in (("jax", jax_preproc, "data_jax"), ("port", preproc, "data")):
        a = [str(tmp_path / data / "sex_info.csv") if v == "SEX" else v for v in argv]
        out[name] = Path(mod.main(["--data_dir", str(tmp_path / data),
                                   "--save_dir", str(tmp_path / f"csv_{name}"), *a]))
    assert out["port"].name == out["jax"].name
    assert ("_large3_400_control_" in out["port"].name) == control
    want = out["jax"].read_text().replace(str(tmp_path / "data_jax"), str(tmp_path / "data"))
    assert out["port"].read_text() == want
    df = pd.read_csv(out["port"])
    assert len(df) == 2 * N_VOLS and df.columns[0] == "Unnamed: 0"
    assert preproc.discover_subjects(str(tmp_path / "data")) == ["sub-A00070", "sub-A00071"]


def test_preproc_excludes_the_reference_subject(tmp_path):
    for d in ("sub-A00058952", "sub-A00070", "sub-B1", "other"):
        (tmp_path / d).mkdir()
    assert preproc.discover_subjects(str(tmp_path)) == \
        jax_preproc.discover_subjects(str(tmp_path)) == ["sub-A00070"]


# ---------------------------------------------------------------------------
# beta_maps
# ---------------------------------------------------------------------------

def test_beta_maps_float64_csv_matches_jax(feat_tree, tmp_path):  # noqa: F811
    """tests/test_beta_maps_cli.py's fixture: the port's float64 CSV is the
    JAX package's byte for byte."""
    root, sex_path, _, _ = feat_tree
    args = ["--root_dir", root, "--data_dims", *map(str, DIMS), "--sex_covars_map", sex_path]
    want = jax_beta_maps.main(args + ["--output_dir", str(tmp_path / "jax")])
    got = beta_maps.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert Path(got).name == Path(want).name == "scld_GLM_beta_maps.csv"
    assert Path(got).read_bytes() == Path(want).read_bytes()


def test_beta_maps_float32_recovers_betas(feat_tree, tmp_path):  # noqa: F811
    """The torch float32 solve (on the CPU here) within the bound of
    tests/test_beta_maps_cli.py (rtol 2e-3, atol 2e-4 after max-scaling)."""
    root, sex_path, true_betas, sex_map = feat_tree
    out = beta_maps.main(["--root_dir", root, "--output_dir", str(tmp_path),
                          "--data_dims", *map(str, DIMS), "--sex_covars_map", sex_path,
                          "--solve_dtype", "float32", "--device", "cpu"])
    df = pd.read_csv(out)
    assert list(df.columns[1:]) == ["task", "x", "y", "z", "xrot", "yrot", "zrot", "sex"]
    got = df.iloc[:, 1:].to_numpy().T
    expected = np.concatenate([true_betas, sex_map.reshape(1, -1)], axis=0)
    for i in range(8):
        np.testing.assert_allclose(got[i], expected[i] / expected[i].max(),
                                   rtol=2e-3, atol=2e-4)


def test_beta_maps_solve_float32_matches_jax():
    """solve_beta_maps at float32 against the JAX package's, on a random
    well-conditioned system: rtol 1e-4 (two fp32 least-squares solvers)."""
    rng = np.random.default_rng(2)
    gamma = rng.normal(size=(60, 7))
    y = (gamma @ rng.normal(size=(7, 50)) + 0.01 * rng.normal(size=(60, 50))).T
    want = jax_beta_maps.solve_beta_maps(gamma, y, dtype="float32")
    got = beta_maps.solve_beta_maps(gamma, y, dtype="float32", device="cpu")
    assert got.dtype == np.float64 and got.shape == (7, 50)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(beta_maps.solve_beta_maps(gamma, y),
                                  jax_beta_maps.solve_beta_maps(gamma, y))


def test_beta_maps_missing_feat_dir_rejected(tmp_path):
    root = tmp_path / "r"
    (root / "sub-A00070").mkdir(parents=True)  # subject without .feat
    with pytest.raises(AssertionError, match="feat"):
        beta_maps.main(["--root_dir", str(root), "--output_dir", str(tmp_path),
                        "--data_dims", "2", "2", "2", "3", "--sex_covars_map", "x",
                        "--device", "cpu"])


def test_parsers_match_jax():
    """add_signal and preproc take the JAX parsers' options exactly;
    beta_maps adds only --device, the oracle only --device and
    --tpu_products / --no-tpu_products (the TPU's product arithmetic,
    ``VAEGAMConfig.tpu_products``; off by default)."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.const)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    jax_tool = _jax_tool_options()
    for mine, theirs, extra in (
            (options(add_signal.build_parser()), options(jax_add_signal.build_parser()), set()),
            (options(preproc.build_parser()), options(jax_preproc.build_parser()), set()),
            (options(beta_maps.build_parser()), options(jax_beta_maps.build_parser()),
             {"device"}),
            (options(ce.build_parser()), jax_tool, {"device", "tpu_products"})):
        assert set(mine) - set(theirs) == extra
        for dest, spec in theirs.items():
            assert mine[dest] == spec, dest


def _jax_tool_options():
    """The JAX oracle's options, from its parser (built in its main)."""
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen.update({act.dest: (tuple(act.option_strings), act.default, act.choices,
                                act.nargs, act.const)
                     for act in self._actions if act.option_strings and act.dest != "help"})
        raise _Stop

    argparse.ArgumentParser.parse_args = capture
    try:
        jax_ce.main([])
    except _Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _trainer_inputs(tool, module, work, argv, monkeypatch):
    """Run a package's oracle up to its Trainer and return what the Trainer
    was given: (config, xu_ranges, glm_maps, keyword arguments)."""
    seen = {}

    class Capture:
        def __init__(self, config, xu_ranges, glm_maps=None, **kw):
            seen.update(config=config, xu=xu_ranges, glm=glm_maps, kw=kw)
            raise _Stop

    monkeypatch.setattr(module, "Trainer", Capture)
    with pytest.raises(_Stop):
        tool.main(["--work_dir", str(work), *argv])
    return seen


def test_oracle_trainer_inputs_match_jax(tmp_path, monkeypatch):
    """2 subjects x 12 volumes at 31x37x27 with motion artifacts (the
    multi-subject default) and a sex effect: the same data files (payloads,
    CSV with its paths mapped), GLM maps bit for bit in all 9 columns, the
    same inducing ranges and the same model config (GLM scale 10, no
    neural covariates, qu_s_cholesky, fused norm statistics, fp32), the
    same seed and no TensorBoard."""
    import vaegam_tpu.train as jax_train
    import vaegam_tpu_torch.train as port_train

    argv = ["--img_shape", *map(str, MOTION_SHAPE), "--n_vols", str(N_VOLS),
            "--n_subjs", "2", "--sex_effect", "200", "--intensity", "400"]
    want = _trainer_inputs(jax_ce, jax_train, tmp_path / "jax", argv, monkeypatch)
    got = _trainer_inputs(ce, port_train, tmp_path / "port", argv + ["--device", "cpu"],
                          monkeypatch)
    assert got["glm"].dtype == want["glm"].dtype == np.float32
    np.testing.assert_array_equal(got["glm"], want["glm"])
    assert all(np.abs(got["glm"][:, c]).max() > 0 for c in range(1, 9))
    np.testing.assert_array_equal(np.asarray(got["xu"]), np.asarray(want["xu"]))
    for field in ("glm_reg_scale", "neural_covariates", "img_shape", "qu_s_cholesky",
                  "fused_norm_stats", "nf", "num_latents", "conv_dtype", "x64_epsilon"):
        assert getattr(got["config"], field) == getattr(want["config"], field), field
    assert got["config"].glm_reg_scale == 10.0 and got["config"].qu_s_cholesky
    assert got["kw"]["seed"] == want["kw"]["seed"] and got["kw"]["enable_tb"] is False
    assert got["kw"]["epoch_scan"] is want["kw"]["epoch_scan"] is False
    csvs = {k: sorted((tmp_path / k).glob("preproc_dset_zscored_*.csv")) for k in ("jax", "port")}
    assert [p.name for p in csvs["port"]] == [p.name for p in csvs["jax"]]
    _assert_same_tree(tmp_path / "jax", tmp_path / "port",
                      mapped=[(str(tmp_path / "jax"), str(tmp_path / "port"))])


@pytest.mark.parametrize("case", ["recovered", "weak", "negative"])
def test_recovery_metrics_match_the_jax_formulas(case):
    """A planted task map: the port's function against the JAX tool's
    formulas (control_experiment.py:436-446,519) written out here."""
    from vaegam_tpu.cli.add_signal import build_control_signal as jax_signal

    rng = np.random.default_rng(3)
    mask = jax_signal("simple", 1.0, 1, 7, img_shape=REF_GRID) > 0
    task_map = rng.normal(0, 0.01, REF_GRID).astype(np.float32)
    task_map[mask] += {"recovered": 0.3, "weak": 0.01, "negative": -0.3}[case]
    got = ce.recovery_metrics(task_map, 1000.0, REF_GRID)
    inside = float(np.mean(np.abs(task_map[mask])))
    outside = float(np.mean(np.abs(task_map[~mask])))
    contrast = inside / max(outside, 1e-12)
    expected = 1000.0 / 3284.5
    inside_mean = float(np.mean(task_map[mask]))
    assert got == {"inside_mean": inside_mean, "expected": expected, "abs_inside": inside,
                   "abs_outside": outside, "contrast": contrast,
                   "recovered": bool(contrast > 2.0 and inside_mean > 0.25 * expected)}
    assert got["recovered"] == (case == "recovered")


def _jax_result_keys():
    """The keys of the JAX tool's result dict literal, from its source."""
    tree = ast.parse((ROOT / "vaegam_tpu" / "tools" / "control_experiment.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result" \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys if k is not None}
    raise AssertionError("no result dict in the JAX tool")


def test_oracle_end_to_end_on_the_cpu(tmp_path):
    """--device cpu at 21x25x21, 12 volumes, batch 8, 2 epochs, --no_gate
    --max_skips 5: exit 0, the JAX tool's keys (and skips_ok; epoch_scan
    off by default), the recon and averaged trees, final.tar
    (tests/test_torch_port_epoch_scan.py runs it with --epoch_scan)."""
    work = tmp_path / "work"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ce.main(["--work_dir", str(work), "--device", "cpu", "--img_shape",
                      *map(str, SHAPE), "--n_vols", str(N_VOLS), "--batch_size", "8",
                      "--epochs", "2", "--no_gate", "--max_skips", "5"])
    assert rc == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert _jax_result_keys() | {"max_skips", "skips_ok"} <= set(result)
    assert result["img_shape"] == list(SHAPE) and result["epochs"] == 2
    assert result["conv_dtype"] == "float32" and result["device"] == "cpu"
    assert result["epoch_scan"] is False
    assert isinstance(result["recovered"], bool) and result["skips_ok"] is True
    assert set(result["stage_seconds"]) == {"generate", "add_signal", "preproc", "train",
                                            "recon", "averages"}
    run = work / "run"
    assert (run / "final.tar").exists()
    vols = sorted(os.listdir(run / "reconstructions" / "002_model_recons" / "sub-A00070"))
    assert vols == sorted(f"vol_{v}" for v in range(N_VOLS))
    avgs = sorted(os.listdir(run / "reconstructions" / "002_avg_model_recons"))
    assert "task_avg.nii" in avgs and "sub-A00070" in avgs


def test_entry_points_need_a_card_or_cpu(tmp_path, feat_tree):  # noqa: F811
    """Without --device and without a card, the oracle and beta_maps raise
    before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ce.main(["--work_dir", str(tmp_path / "never")])
    root, sex_path, _, _ = feat_tree
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beta_maps.main(["--root_dir", root, "--output_dir", str(tmp_path / "never"),
                        "--data_dims", *map(str, DIMS), "--sex_covars_map", sex_path])
    assert not (tmp_path / "never").exists()


# ---------------------------------------------------------------------------
# the oracle's training, step by step against the JAX Trainer's
# ---------------------------------------------------------------------------

TRAJ_EPOCHS = 4
TRAJ_BATCH = 5   # 12 volumes: steps of 5, 5 and a tail of 2, as 98 at batch 32


def test_oracle_training_tracks_jax(tmp_path, monkeypatch):
    """Four epochs of the oracle's training on its own data at 21x25x21 (12
    volumes at batch 5: steps of 5, 5 and a tail of 2 in each epoch, as 98
    volumes at batch 32 end on 2), the thin model (nf=2, 8 latents) at the
    oracle's flags (GLM regularizer on the ground-truth maps, qu_s_cholesky,
    fused norm statistics, no neural covariates, the skip rule on): the JAX
    Trainer and the port's, from the same weights, each through its own
    device loader and epoch loop, with the JAX Trainer's noise fed to the
    port step by step.

    Both sides run in float64 (the JAX side as tests/torch_port_common.py
    lifts it, its gather's float32 cast included).  The inducing grids span
    the data, so at this grid Kuu's condition number exceeds 1e5 (asserted)
    and a float32 evaluation of the motion-GP gains is rounding-bound in
    either package: two float32 runs part within the first steps.  In
    float64 the batches are the same indices, every step's loss agrees
    within rtol 1e-9 and every parameter within 1e-6 of its leaf's scale
    after each epoch, sa_task included, except logkvar: the posterior
    depends on the kernel variance only through Kqq - A Kuu A^T, which
    cancels to rounding at this conditioning, and Adam scales that
    rounding-level gradient up to steps of about lr, so logkvar may differ
    by up to lr per step.  No step is skipped and no gain Cholesky falls
    back on either side."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import vaegam_tpu.train as jax_train
    import vaegam_tpu.train.loop as jax_loop
    from torch_port_common import (_JnpFloat32AsFloat64, f64_jax, f64_port, jax_float64,
                                   jax_noise, to_np)
    from vaegam_tpu.data import setup_device_loaders as jax_loaders
    from vaegam_tpu_torch.data import setup_device_loaders as port_loaders
    from vaegam_tpu_torch.models import VAEGAMConfig as PortConfig
    from vaegam_tpu_torch.models import gp as port_gp
    from vaegam_tpu_torch.models.vaegam import gp_transforms
    from vaegam_tpu_torch.train import Trainer as PortTrainer
    from vaegam_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

    work = tmp_path / "jax"
    seen = _trainer_inputs(jax_ce, jax_train, work,
                           ["--img_shape", *map(str, SHAPE), "--n_vols", str(N_VOLS)],
                           monkeypatch)
    monkeypatch.undo()
    csv = str(next(work.glob("preproc_dset_zscored_*.csv")))
    thin = dict(nf=2, num_latents=8)
    jcfg = dataclasses.replace(seen["config"], **thin)
    pcfg = PortConfig(glm_reg_scale=jcfg.glm_reg_scale, neural_covariates=False,
                      img_shape=SHAPE, qu_s_cholesky=True, fused_norm_stats=True, **thin)
    assert jcfg.qu_s_cholesky and jcfg.fused_norm_stats and not jcfg.neural_covariates
    assert jcfg.glm_reg_scale == 1.0 and seen["kw"]["seed"] == 1
    monkeypatch.setattr(jax_loop, "jnp", _JnpFloat32AsFloat64())   # the gather's cast

    with jax_float64():
        jt = jax_train.Trainer(jcfg, seen["xu"], glm_maps=seen["glm"], seed=1,
                               enable_tb=False)
        jt.params, jt.consts = f64_jax(to_np(jt.params)), f64_jax(to_np(jt.consts))
        jt.opt_state = jt._tx_init(jt.params)
        inner = jt._build_gather_train_step()
        params, consts = params_from_jax(to_np(jt.params), to_np(jt.consts), pcfg, "cpu")
        pt = PortTrainer(pcfg, seed=1, enable_tb=False, device="cpu",
                         params=f64_port(params), consts=f64_port(consts))
        kvar, ls = gp_transforms(pt.params["gp"], pcfg)
        xu = pt.consts["xu"]
        kuu = port_gp.rbf_gram(xu, xu, kvar, ls).detach().numpy()
        assert min(np.linalg.cond(k) for k in kuu) > 1e5
        jl = jax_loaders(batch_size=TRAJ_BATCH, train_csv=csv, test_csv=csv, seed=1)
        pl = port_loaders(batch_size=TRAJ_BATCH, train_csv=csv, test_csv=csv, seed=1,
                          device="cpu")
        jl["Shuffled_train"]._covs = jnp.asarray(np.asarray(jl["Shuffled_train"]._covs),
                                                 jnp.float64)

        steps, fed, port_losses = [], [], []

        def jax_step(params, opt_state, key, vols, covs, idx):
            _, sub = jax.random.split(key)      # the step's key (loop.py:196-197)
            draws = jax_noise(sub, len(idx), jcfg.num_latents)
            out = inner(params, opt_state, key, vols, covs, idx)   # donates key
            steps.append((np.asarray(idx), draws, float(out[3])))
            return out

        gather, step = pl["Shuffled_train"].gather, pt.train_step

        def port_gather(sel):
            fed.append(np.asarray(sel))
            return tuple(t.double() for t in gather(sel))

        def port_step(covs, x, noise=None):
            draws = steps[len(port_losses)][1]
            loss, aux = step(covs, x, noise=tuple(torch.from_numpy(np.array(d)) for d in draws))
            port_losses.append(float(loss))
            return loss, aux

        jt._gather_train_step = jax_step
        pl["Shuffled_train"].gather = port_gather
        pt.train_step = port_step
        for _ in range(TRAJ_EPOCHS):
            want = jt.train_epoch(jl["Shuffled_train"])
            got = pt.train_epoch(pl["Shuffled_train"])
            assert [len(i) for i, _, _ in steps[-3:]] == [5, 5, 2]
            assert len(fed) == len(steps)
            for (idx, _, _), sel in zip(steps, fed):
                np.testing.assert_array_equal(sel, idx)
            np.testing.assert_allclose(port_losses, [l for _, _, l in steps], rtol=1e-9)
            np.testing.assert_allclose(got, want, rtol=1e-9)
            mine, _ = params_to_jax(pt.params, None, pcfg)
            n_steps = len(steps)
            for path, want_leaf in jax.tree_util.tree_leaves_with_path(to_np(jt.params)):
                got_leaf = mine
                for k in path:
                    got_leaf = got_leaf[k.key]
                name = jax.tree_util.keystr(path)
                bound = (n_steps * pt.lr if name == "['gp']['logkvar']"
                         else 1e-6 * max(1.0, float(np.abs(want_leaf).max())))
                np.testing.assert_allclose(np.asarray(got_leaf, np.float64), want_leaf,
                                           rtol=0, atol=bound, err_msg=name)
    assert len(steps) == 3 * TRAJ_EPOCHS
    assert int(jt.opt_state.total_notfinite) == int(pt.opt_state["total_notfinite"]) == 0
    assert jt.mvn_fallbacks == pt.mvn_fallbacks == 0
