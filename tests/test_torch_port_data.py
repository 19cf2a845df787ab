"""The port's host utilities and data path against the JAX package's.

NIfTI codec and native decoder (byte-identical arrays and files), the CSV
dataset, the streaming DataLoader and the dataset-backed device cache (every
batch equal for two epochs), the cache's half-precision storage, and the
stats helpers.  The study is the e2e fixture's subject tree on the small
21x25x21 grid, with one subject stored uncompressed so both codecs run.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest
import torch

from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.data import DataLoader as JaxDataLoader
from vaegam_tpu.data import FMRIDataset as JaxDataset
from vaegam_tpu.data import setup_data_loaders as jax_setup_data_loaders
from vaegam_tpu.data.device_cache import DeviceResidentLoader as JaxDeviceLoader
from vaegam_tpu.utils import nifti as jax_nifti
from vaegam_tpu.utils import nifti_native as jax_native
from vaegam_tpu.utils import stats as jax_stats

from vaegam_tpu_torch.data import (DataLoader, DeviceResidentLoader, FMRIDataset,
                                   GLOBAL_SCALE, setup_data_loaders,
                                   setup_device_loaders)
from vaegam_tpu_torch.parallel import DataMesh
from vaegam_tpu_torch.utils import nifti, nifti_native, stats


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """(root, csv): 2 subjects x 6 volumes; the second stored as .nii."""
    root = str(tmp_path_factory.mktemp("subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=6, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    df = pd.read_csv(csv)
    gz = df.iloc[:, 3].unique()[1]
    plain = gz[: -len(".gz")]
    with gzip.open(gz, "rb") as f, open(plain, "wb") as g:
        g.write(f.read())
    df.iloc[:, 3] = df.iloc[:, 3].replace(gz, plain)
    df.to_csv(csv, index=False)
    return root, csv


def _paths(csv):
    return list(pd.read_csv(csv).iloc[:, 3].unique())


def _as_np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = _as_np(got[k]), _as_np(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# NIfTI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_save_and_load_match_jax(tmp_path, suffix):
    """The same image written by both codecs gives the same bytes (inside
    the gzip container, whose header carries a time stamp), and each codec
    reads the other's file to the same array, affine and header."""
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(5, 6, 4, 3)).astype(np.float32)
    aff = np.diag([3.0, 2.0, 1.5, 1.0])
    mine, theirs = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    nifti.save(nifti.Nifti1Image(arr, aff), mine)
    jax_nifti.save(jax_nifti.Nifti1Image(arr, aff), theirs)
    read = (lambda p: gzip.open(p).read()) if suffix.endswith(".gz") else \
        (lambda p: open(p, "rb").read())
    assert read(mine) == read(theirs)
    for path in (mine, theirs):
        a, b = nifti.load(path), jax_nifti.load(path)
        np.testing.assert_array_equal(np.asarray(a.dataobj), np.asarray(b.dataobj))
        np.testing.assert_array_equal(a.affine, b.affine)
        assert a.header._rec.tobytes() == b.header._rec.tobytes()


def test_decode_f32_matches_jax(study):
    """decode_f32 and decode_many_f32 give the JAX package's arrays, byte
    for byte, on the study's .nii and .nii.gz files."""
    _, csv = study
    paths = _paths(csv)
    assert {p.endswith(".gz") for p in paths} == {True, False}
    assert nifti_native.available() == jax_native.available()
    for p, many in zip(paths, nifti_native.decode_many_f32(paths)):
        want = jax_native.decode_f32(p)
        got = nifti_native.decode_f32(p)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes(order="A") == want.tobytes(order="A")
        np.testing.assert_array_equal(many, want)


def test_native_batch_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(3, 4 * 5 * 6)).astype(np.float32)
    header = nifti.encode_header(None, (4, 5, 6), np.float32, np.eye(4))
    assert header == jax_nifti.encode_header(None, (4, 5, 6), np.float32, np.eye(4))
    mine = [str(tmp_path / f"m{i}.nii") for i in range(3)]
    theirs = [str(tmp_path / f"t{i}.nii") for i in range(3)]
    nifti_native.write_batch_f32(header, data, (4, 5, 6), mine)
    jax_native.write_batch_f32(header, data, (4, 5, 6), theirs)
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


# ---------------------------------------------------------------------------
# dataset and loaders
# ---------------------------------------------------------------------------

def test_dataset_items_and_gathers_match_jax(study):
    _, csv = study
    ours, ref = FMRIDataset(csv), JaxDataset(csv)
    assert len(ours) == len(ref) == 12 and ours.unique_subjs == ref.unique_subjs
    for i in range(len(ref)):
        _assert_batches_equal(ours[i], ref[i])
    assert ours[0]["volume"].shape == SMALL_SHAPE and ours[7]["subjid"] == 1
    raw = np.asarray(nifti.load(ours._nii_paths[0]).dataobj)[:, :, :, 0]
    np.testing.assert_array_equal(ours[0]["volume"],
                                  (raw / np.float32(GLOBAL_SCALE)).astype(np.float32))
    rows = np.array([11, 0, 6, 3, 7])
    for chunk in (0, 1):
        _assert_batches_equal(FMRIDataset(csv).gather(rows, chunk_files=chunk),
                              ref.gather(rows, chunk_files=chunk))
    ours.prewarm()
    assert len(ours._cache) == 2
    ours.trim_cache()


@pytest.mark.parametrize("shuffle", [True, False])
def test_data_loader_batches_match_jax(study, shuffle):
    """Every batch of two epochs (set_epoch 0 and 1) equal, ragged tail
    included (12 rows at batch 5)."""
    _, csv = study
    ours = DataLoader(FMRIDataset(csv), 5, shuffle=shuffle, seed=3)
    ref = JaxDataLoader(JaxDataset(csv), 5, shuffle=shuffle, seed=3)
    assert len(ours) == len(ref) == 3 and ours.num_samples == ref.num_samples
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    mine = setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv, seed=2)
    theirs = jax_setup_data_loaders(batch_size=4, train_csv=csv, test_csv=csv, seed=2)
    assert list(mine) == list(theirs)
    for key in theirs:
        assert mine[key].shuffle == theirs[key].shuffle


@pytest.mark.parametrize("shuffle", [True, False])
def test_device_loader_batches_match_jax(study, shuffle):
    """The dataset-backed device cache: index batches and gathered batches
    (volume, covariates, subjid, vol_num) equal to the JAX loader's."""
    _, csv = study
    ours = DeviceResidentLoader(FMRIDataset(csv), 5, shuffle=shuffle, seed=4,
                                device="cpu")
    ref = JaxDeviceLoader(JaxDataset(csv), 5, shuffle=shuffle, seed=4)
    assert len(ours) == len(ref) and ours.num_samples == ref.num_samples == 12
    assert set(ours.build_seconds) == {"decode", "upload"}
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for a, b in zip(ours.iter_index_batches(), ref.iter_index_batches()):
            np.testing.assert_array_equal(a, b)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


@pytest.mark.parametrize("dtype,rel", [("float16", 2.0 ** -11), ("bfloat16", 2.0 ** -8)])
def test_half_precision_cache_restores_float32(study, dtype, rel):
    """Stored at half the bytes, gathered as float32 within the dtype's
    rounding (half an ulp: 2^-11 relative for float16, 2^-8 for bfloat16),
    and equal to the JAX cache's values."""
    _, csv = study
    ours = DeviceResidentLoader(FMRIDataset(csv), 4, cache_dtype=dtype, device="cpu")
    ref = JaxDeviceLoader(JaxDataset(csv), 4, cache_dtype=dtype)
    assert ours.vols.dtype == getattr(torch, dtype)
    exact = FMRIDataset(csv).gather(np.arange(12))["volume"]
    covs, vols = ours.gather(np.arange(12))
    assert vols.dtype == torch.float32
    np.testing.assert_allclose(vols.numpy(), exact, rtol=rel, atol=0)
    want = np.concatenate([np.asarray(b["volume"]) for b in ref])
    np.testing.assert_array_equal(vols.numpy(), want)


def test_setup_device_loaders_shares_cache_and_picks_float16(study, tmp_path, capsys):
    _, csv = study
    loaders = setup_device_loaders(batch_size=4, train_csv=csv, test_csv=csv, device="cpu")
    assert set(loaders) == {"Shuffled_train", "UnShuffled_train", "test"}
    shared = loaders["Shuffled_train"].vols
    assert loaders["test"].vols is shared and loaders["UnShuffled_train"].vols is shared
    assert shared.dtype == torch.float32
    assert [loaders[k].shuffle for k in loaders] == [True, False, False]
    # a budget that fits float16 only
    fp32_bytes = 12 * int(np.prod(SMALL_SHAPE)) * 4
    half = setup_device_loaders(batch_size=4, train_csv=csv, test_csv=csv,
                                max_bytes=fp32_bytes - 1, device="cpu")
    assert half["Shuffled_train"].vols.dtype == torch.float16
    assert "caching float16" in capsys.readouterr().out
    # a different test CSV gets its own cache
    other = str(tmp_path / "copy.csv")
    pd.read_csv(csv).to_csv(other, index=False)
    sep = setup_device_loaders(batch_size=4, train_csv=csv, test_csv=other, device="cpu")
    assert sep["test"].vols is not sep["Shuffled_train"].vols
    with pytest.raises(ValueError, match="budget"):
        setup_device_loaders(batch_size=4, train_csv=csv, test_csv=csv,
                             max_bytes=fp32_bytes // 4, device="cpu")


def test_row_sharding_is_refused(study):
    """Row sharding iterates the rows [shard_index::num_shards], as JAX's
    loaders do (the host loader and the device cache: the same batches for
    two epochs, num_samples the dataset's length), and is refused under a
    multi-process mesh, as JAX refuses it: each rank's cache must hold the
    same rows."""
    _, csv = study
    ds, jds = FMRIDataset(csv), JaxDataset(csv)
    mine = setup_device_loaders(batch_size=2, train_csv=csv, test_csv=csv, seed=3,
                                shard_index=1, num_shards=2, device="cpu")
    loaders = [(DataLoader(ds, 2, shuffle=True, seed=3, shard_index=1, num_shards=2),
                JaxDataLoader(jds, 2, shuffle=True, seed=3, shard_index=1, num_shards=2)),
               (mine["Shuffled_train"],
                JaxDeviceLoader(jds, 2, shuffle=True, seed=3, shard_index=1, num_shards=2))]
    for port, jax_loader in loaders:
        assert port.num_samples == jax_loader.num_samples == len(ds)
        assert len(port) == len(jax_loader) == 3
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            for a, b in zip(port, jax_loader, strict=True):
                np.testing.assert_array_equal(a["vol_num"], np.asarray(b["vol_num"]))
                np.testing.assert_array_equal(np.asarray(a["volume"]), np.asarray(b["volume"]))
    two_ranks = DataMesh(0, 2, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="multi-process mesh"):
        setup_device_loaders(train_csv=csv, test_csv=csv, num_shards=2, mesh=two_ranks)
    with pytest.raises(ValueError, match="multi-process mesh"):
        DeviceResidentLoader(ds, num_shards=2, mesh=two_ranks)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_stats_match_jax(study, tmp_path):
    _, csv = study
    df = pd.read_csv(csv)
    other = df.copy()
    other["rot_z"] = other["rot_z"] * 3 + 1
    path = str(tmp_path / "other.csv")
    other.to_csv(path, index=False)
    assert stats.get_xu_ranges([csv, path]) == jax_stats.get_xu_ranges([csv, path])
    pd.testing.assert_frame_equal(stats.zscore(other.copy()),
                                  jax_stats.zscore(other.copy()))
    np.testing.assert_array_equal(stats.mk_spherical_mask(7, 2),
                                  jax_stats.mk_spherical_mask(7, 2))
    maps = np.random.default_rng(2).uniform(0.5, 2, size=(3, 10))
    np.testing.assert_array_equal(stats.scale_beta_maps(maps.copy()),
                                  jax_stats.scale_beta_maps(maps.copy()))


@pytest.mark.parametrize("value", ["yes", "True", "t", "Y", "1", "no", "FALSE",
                                   "f", "n", "0", True, False, "maybe"])
def test_str2bool_matches_jax(value):
    try:
        want = jax_stats.str2bool(value)
    except Exception as e:  # noqa: BLE001 - the JAX side's error decides
        with pytest.raises(type(e)):
            stats.str2bool(value)
    else:
        assert stats.str2bool(value) is want
