"""The port's Trainer loop and train CLI against the JAX package's.

train_loop's test/save schedule, the qu_S diagnostics dump, the CLI end to
end on the CPU without its output stage (device cache, streaming fallback,
bf16, resume; tests/test_torch_port_outputs.py runs the output stage), the
flags it refuses, and its parser against the JAX parser.  Thin model (nf=2,
8 latents, 21x25x21) on the e2e fixture's subject tree.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.cli.train import build_parser as jax_build_parser
from vaegam_tpu.data import setup_data_loaders as jax_setup_data_loaders
from vaegam_tpu.models import VAEGAMConfig as JaxConfig
from vaegam_tpu.train import Trainer as JaxTrainer

from vaegam_tpu_torch.cli.train import build_parser, main
from vaegam_tpu_torch.data import DataLoader, DeviceResidentLoader, setup_data_loaders
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.train import Trainer, load_checkpoint
from vaegam_tpu_torch.utils.jax_params import params_to_jax
from vaegam_tpu_torch.utils.stats import get_xu_ranges
from vaegam_tpu_torch.utils.tree import tree_items

from torch_port_common import THIN


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """(design csv, GLM-maps csv): 2 subjects x 6 volumes, small grid."""
    root = str(tmp_path_factory.mktemp("subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=6, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    glm = os.path.join(root, "glm.csv")
    rng = np.random.default_rng(0)
    pd.DataFrame(rng.normal(size=(int(np.prod(SMALL_SHAPE)), 8))).to_csv(glm)
    return csv, glm


def _argv(study, save_dir, *extra):
    csv, glm = study
    return ["--train_csv", csv, "--test_csv", csv, "--glm_maps", glm,
            "--save_dir", str(save_dir), "--batch-size", "4", "--nf", "2",
            "--num_latents", "8", "--img_shape", *map(str, SMALL_SHAPE),
            "--device", "cpu", "--no_outputs", *extra]


def test_train_loop_schedule_matches_jax(study, tmp_path):
    """3 epochs, test_freq 2, save_freq 1: the same checkpoint names and
    the same loss keys as the JAX train_loop (test at epochs 0 and 2; no
    save at epoch 0), all losses finite."""
    csv, _ = study
    xu = get_xu_ranges([csv, csv])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    t = Trainer(VAEGAMConfig(**THIN), xu, save_dir=str(port_dir), device="cpu")
    t.train_loop(setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv),
                 epochs=3, test_freq=2, save_freq=1)
    jt = JaxTrainer(JaxConfig(**THIN), xu, save_dir=str(jax_dir), enable_tb=False)
    jt.train_loop(jax_setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv),
                  epochs=3, test_freq=2, save_freq=1)
    names = sorted(f for f in os.listdir(port_dir) if f.endswith(".tar"))
    assert names == sorted(f for f in os.listdir(jax_dir) if f.endswith(".tar")) == \
        ["checkpoint_001.tar", "checkpoint_002.tar"]
    assert {k: sorted(v) for k, v in t.loss.items()} == \
        {k: sorted(v) for k, v in jt.loss.items()} == {"train": [0, 1, 2], "test": [0, 2]}
    assert all(np.isfinite(v) for d in t.loss.values() for v in d.values())
    assert t.epoch == 3 and sorted(t.epoch_seconds) == [0, 1, 2]


def test_nonfinite_epoch_dumps_qu_S_diagnostics(tmp_path):
    """A qu_S with a negative diagonal turns every loss NaN: the epoch
    reports a NaN loss, every step is skipped and the dump is written."""
    t = Trainer(VAEGAMConfig(**THIN), [[-2.0, 2.0]] * 6, save_dir=str(tmp_path),
                device="cpu")
    with torch.no_grad():
        t.params["gp"]["qu_S"][2, 0, 0] = -1.0
    rng = np.random.default_rng(1)
    loader = DeviceResidentLoader.from_arrays(
        rng.uniform(size=(8,) + SMALL_SHAPE), rng.normal(size=(8, 8)), batch_size=4,
        device="cpu")
    assert not np.isfinite(t.train_epoch(loader))
    assert int(t.opt_state["total_notfinite"]) == 2 and int(t.opt_state["count"]) == 0
    assert not bool(t.opt_state["last_finite"]) and int(t.opt_state["notfinite_count"]) == 2
    with open(tmp_path / "qu_S_diagnostics.tar", "rb") as f:
        diag = pickle.load(f)
    assert diag["cov_id"] == 3 and diag["batch_vals"].shape == (4, 8)
    np.testing.assert_array_equal(diag["qu_S"], t.params["gp"]["qu_S"][2].detach().numpy())
    assert not t.check_gp_stability()


def test_cli_trains_and_resumes_on_the_cpu(study, tmp_path):
    """--device cpu --no_outputs: 2 epochs on the device cache write
    checkpoint_001.tar and a TensorBoard run; --from_ckpt resumes it for 1 epoch at epoch 2 with
    the saved params and the loss history carried over."""
    out = tmp_path / "run"
    t, loaders = main(_argv(study, out, "--epochs", "2", "--test_freq", "1",
                            "--save_freq", "1"))
    assert isinstance(loaders["Shuffled_train"], DeviceResidentLoader)
    assert loaders["test"].vols is loaders["Shuffled_train"].vols
    assert sorted(os.listdir(out)) == ["checkpoint_001.tar", "run"]  # run/: TensorBoard
    assert sorted(t.loss["train"]) == sorted(t.loss["test"]) == [0, 1]
    saved = load_checkpoint(str(out / "checkpoint_001.tar"))
    mine, _ = params_to_jax(t.params, None, t.config)
    for (path, a), (_, b) in zip(tree_items(mine), tree_items(saved["params"])):
        np.testing.assert_array_equal(a, b, err_msg=path)

    r, _ = main(_argv(study, out, "--epochs", "1", "--test_freq", "1",
                      "--save_freq", "1", "--from_ckpt",
                      "--ckpt_path", str(out / "checkpoint_001.tar")))
    assert r.epoch == 3 and sorted(r.loss["train"]) == [0, 1, 2]
    assert r.loss["train"][1] == t.loss["train"][1]
    assert np.isfinite(r.loss["train"][2]) and np.isfinite(r.loss["test"][2])
    assert sorted(os.listdir(out)) == ["checkpoint_001.tar", "checkpoint_002.tar", "run"]


def test_cli_streaming_fallback_and_bf16(study, tmp_path, monkeypatch, capsys):
    """A cache budget of one byte sends the CLI to the streaming DataLoader
    (said on stdout); the bf16 recipe with joint norm statistics trains and
    logs TensorBoard under run/."""
    monkeypatch.setenv("VAEGAM_CACHE_MAX_BYTES", "1")
    t, loaders = main(_argv(study, tmp_path, "--epochs", "1", "--test_freq", "1",
                            "--conv_dtype", "bfloat16", "--fused_norm_stats"))
    out = capsys.readouterr().out
    assert "[device cache disabled]" in out and "item 5" in out and "item 7" not in out
    assert t.writer is not None and (tmp_path / "run").is_dir()
    assert isinstance(loaders["Shuffled_train"], DataLoader)
    assert t.config.conv_dtype == torch.bfloat16 and t.config.fused_norm_stats
    assert np.isfinite(t.loss["train"][0]) and np.isfinite(t.loss["test"][0])


@pytest.mark.parametrize("extra,item", [
    (("--data_parallel",), "item 10"),
    (("--multihost",), "item 10"),
    (("--epoch_scan",), "item 6"),
    (("--qu_s_cholesky",), "item 1"),
    (("--x64_epsilon",), "item 1"),
    (("--stream_dtype", "bfloat16"), "item 5"),
])
def test_cli_refuses_unported_flags_before_any_work(tmp_path, extra, item):
    """Refused before the CSVs are read: the paths given do not exist."""
    argv = ["--train_csv", str(tmp_path / "missing.csv"),
            "--test_csv", str(tmp_path / "missing.csv"), "--device", "cpu",
            "--save_dir", str(tmp_path / "never")]
    with pytest.raises(NotImplementedError, match=item):
        main(argv + list(extra))
    assert not (tmp_path / "never").exists()


def test_parser_accepts_every_jax_flag():
    """Every option of the JAX parser, with its default and choices; the
    port adds only --device."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.const)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    mine, theirs = options(build_parser()), options(jax_build_parser())
    assert set(mine) - set(theirs) == {"device"}
    for dest, spec in theirs.items():
        assert mine[dest] == spec, dest


def test_cli_default_device_needs_a_card(study, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    argv = [a for a in _argv(study, tmp_path, "--epochs", "1") if a != "cpu"]
    argv.remove("--device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
