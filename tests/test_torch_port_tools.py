"""The port's study tools (vaegam_tpu_torch/tools) on the CPU at a tiny size.

Each tool's ``main`` runs with ``--device cpu`` on the thin model (nf=2,
8 latents, 21x25x21) or a small fixture and prints one JSON line, which is
read back and checked for what the tool measures.  The tools' numbers on the
card come from chip_smoke.py's phase 10.  ``make_mnist3_stencil`` must give
the committed golden exactly.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).resolve().parent / "golden"
THIN = ["--nf", "2", "--num_latents", "8", "--img_shape", "21", "25", "21"]


def _json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines, "the tool printed no JSON line"
    return json.loads(lines[-1])


def test_bench_packed_conv(capsys):
    from vaegam_tpu_torch.tools import bench_packed_conv

    ret = bench_packed_conv.main(["--batch", "1", "--iters", "1", "--device", "cpu"])
    out = _json_line(capsys)
    assert out == json.loads(json.dumps(ret))
    assert [(r["layer"], r["dtype"]) for r in out["layers"]] == [
        (n, d) for n in ("convt1", "convt3", "convt5") for d in ("float32", "bfloat16")]
    for row in out["layers"]:
        assert set(row["packs"]) == {f"{a}x{b}" for a, b in bench_packed_conv.PACKS}
        assert row["conv3d"]["fwd_ms"] > 0 and row["conv3d"]["fwd_bwd_ms"] > 0
        for arm in row["packs"].values():
            assert arm["fwd_ms"] > 0 and arm["fwd_bwd_ms"] > 0
            tol = 1e-4 if row["dtype"] == "float32" else 5e-2
            assert arm["max_abs_err"] <= tol * max(1.0, arm["max_abs_out"])
    assert out["layers"][0]["packs"]["4x4"]["flop_inflation"] == 4.0



def test_bench_packed_conv_packs(capsys):
    from vaegam_tpu_torch.tools import bench_packed_conv

    bench_packed_conv.main(["--batch", "1", "--iters", "1", "--packs", "2x2", "4x4",
                            "--device", "cpu"])
    for row in _json_line(capsys)["layers"]:
        assert list(row["packs"]) == ["2x2", "4x4"]
        assert row["packs"]["4x4"]["flop_inflation"] == 4.0

def test_conv5_fullstep_study(capsys):
    from vaegam_tpu_torch.tools import conv5_fullstep_study

    conv5_fullstep_study.main(["--batch", "2", "--iters", "2", "--rounds", "1",
                               "--device", "cpu", *THIN])
    out = _json_line(capsys)
    assert set(out["vols_per_s"]) == {f"{m}_{a}" for m in ("eager", "replayed")
                                      for a in ("kernel", "cudnn")}
    assert all(len(v) == 1 and v[0] > 0 for v in out["vols_per_s"].values())
    for mode in ("eager", "replayed"):
        assert out[f"{mode}_kernel_over_cudnn"] > 0
    # the plain conv5 and F.conv3d on the same weights, batch and noise
    first = out["first_step_loss"]
    np.testing.assert_allclose(first["kernel"], first["cudnn"], rtol=1e-5)
    assert all(np.isfinite(v) for v in out["mean_loss_last_block"].values())


def test_bench_recon(capsys):
    from vaegam_tpu_torch.tools import bench_recon

    bench_recon.main(["--n_subjs", "1", "--n_vols", "6", "--widths", "4", "32",
                      "--device", "cpu", *THIN])
    out = _json_line(capsys)
    assert out["n_vols_total"] == 6 and set(out["widths"]) == {"4", "32"}
    for w in out["widths"].values():
        assert w["fwd_vols_per_s"] > 0 and w["full_recon_s"] > 0 and w["avg_maps_s"] > 0


def test_epsilon_precision_study(capsys):
    from vaegam_tpu_torch.tools import epsilon_precision_study

    epsilon_precision_study.main(["--steps", "3", "--batch", "2", "--device", "cpu"])
    out = _json_line(capsys)
    assert out["epsilon_dtypes"] == ["torch.float32", "torch.float64"]
    assert np.isfinite(out["final_loss_fp32"]) and np.isfinite(out["final_loss_fp64"])
    # three Adam steps of lr 1e-3 from the same start: the arms stay close
    assert out["max_rel_loss_delta"] < 1e-3 and out["epsilon_max_abs_delta"] < 1e-5


def test_beta_solve_precision_study(capsys):
    from vaegam_tpu_torch.tools import beta_solve_precision_study

    beta_solve_precision_study.main(["--n_subj", "2", "--n_vox", "700", "--device", "cpu"])
    out = _json_line(capsys)
    assert out["sum_T"] == 196 and out["cond_gamma"] > 10
    assert out["float64"]["max_drift"] < 1e-8
    assert out["float64"]["max_drift"] <= out["float32"]["max_drift"] < 1e-2


def test_make_mnist3_stencil_reproduces_the_golden(capsys, tmp_path):
    from vaegam_tpu_torch.tools import make_mnist3_stencil

    dst = tmp_path / "stencil.npy"
    make_mnist3_stencil.main(["--raw_digit", str(GOLDEN / "raw_digit3_28x28.npy"),
                              "--out", str(dst)])
    want = np.load(GOLDEN / "mnist3_binary_stencil.npy")
    got = np.load(dst)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _json_line(capsys)["voxels_on"] == int(want.sum())


def test_bench_mni_prefetch(capsys):
    from vaegam_tpu_torch.tools import bench_mni_prefetch

    bench_mni_prefetch.main(["--n_subjs", "1", "--n_vols", "6", "--batch", "4",
                             "--epochs", "1", "--device", "cpu", *THIN])
    out = _json_line(capsys)
    assert set(out["vols_per_s"]) == set(bench_mni_prefetch.LOADERS)
    assert all(v > 0 for v in out["vols_per_s"].values())
    assert set(out["upload_s"]) == {"cache_fp32", "cache_bf16"}


def test_mni_mesh_dryrun_two_ranks(capsys):
    from vaegam_tpu_torch.tools import mni_mesh_dryrun

    mni_mesh_dryrun.main(["--n_ranks", "2", "--device", "cpu", *THIN])
    out = _json_line(capsys)
    assert out["ok"] and out["n_ranks"] == 2 and out["epoch_scan"] is False
    assert out["cache_dtype"] == "float16" and np.isfinite(out["epoch_loss"])
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    # two global batches of one row a rank; conv5 takes its plain version
    assert out["steps"] == 2 and [r["conv5_launches"] for r in out["ranks"]] == [0, 0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card")
def test_mni_mesh_dryrun_defaults_to_the_card():
    from vaegam_tpu_torch.tools import mni_mesh_dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mni_mesh_dryrun.main(["--n_ranks", "2", *THIN])


@pytest.mark.parametrize("mode", ["scan", "per_step"])
def test_epoch_scan_diagnosis(capsys, tmp_path, mode):
    from vaegam_tpu_torch.tools import epoch_scan_diagnosis

    log = tmp_path / "diag.jsonl"
    epoch_scan_diagnosis.main(["--epochs", "3", "--n_vols", "6", "--batch_size", "4",
                               "--probe_every", "2", "--mode", mode, "--log", str(log),
                               "--device", "cpu", *THIN])
    out = _json_line(capsys)
    epochs = [r for r in out["records"] if "epoch" in r]
    assert out["epochs_run"] == 3 and [r["epoch"] for r in epochs] == [0, 1, 2]
    for r in epochs:
        assert np.isfinite(r["loss"]) and r["s"] >= r["return_s"] >= 0
        assert r["probe_step_s"] > 0 and r["host_rss_mib"] > 0
    assert [json.loads(ln) for ln in log.read_text().splitlines()] == out["records"]
