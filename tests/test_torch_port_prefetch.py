"""The port's prefetch loader against the JAX package's.

``vaegam_tpu_torch.data.PrefetchLoader`` on the CPU (no streams or pinned
memory there; the card's copy path runs in chip_smoke.py) against
``vaegam_tpu.data.PrefetchLoader``: the same rows in the same batches and
the same float32 values after each wire, epochs 0 and 1, tail batch
included; ``wide_eval_view``'s branch for it; the Trainer's hand-over of
its tensors; the train CLI past the device-cache budget.  2 subjects x 6
volumes at the thin grid, batch 5 (5, 5, 2).
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu.data import FMRIDataset as JaxDataset
from vaegam_tpu.data import PrefetchLoader as JaxPrefetchLoader
from vaegam_tpu.data import wide_eval_view as jax_wide_eval_view

from vaegam_tpu_torch.cli.train import main
from vaegam_tpu_torch.data import (FMRIDataset, PrefetchLoader, setup_prefetch_loaders,
                                   wide_eval_view)
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.parallel import DataMesh
from vaegam_tpu_torch.train import Trainer

from torch_port_common import THIN

WIRES = ["float32", "float16", "bfloat16"]


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prefetch_subjects"))
    make_subject_tree(root, n_subjs=2, n_vols=6, img_shape=SMALL_SHAPE)
    return make_design_csv(root, os.path.join(root, "design.csv"))


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in b.items()}
            for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "in_order"])
@pytest.mark.parametrize("wire", WIRES)
def test_prefetch_batches_match_jax(study, wire, shuffle):
    """Epochs 0 and 1 at seed 3: subjid, vol_num, covariates and the
    float32 volume after the wire, bit for bit; batches of 5, 5 and 2."""
    kw = dict(batch_size=5, shuffle=shuffle, seed=3, transfer_dtype=wire)
    mine = PrefetchLoader(FMRIDataset(study), device="cpu", **kw)
    theirs = JaxPrefetchLoader(JaxDataset(study), **kw)
    assert len(mine) == len(theirs) == 3 and mine.num_samples == 12
    for epoch in (0, 1):
        got = _batches(mine, epoch)
        _assert_same_batches(got, _batches(theirs, epoch))
        assert [len(b["vol_num"]) for b in got] == [5, 5, 2]
        assert all(b["volume"].dtype == np.float32 for b in got)
    if wire != "float32":
        exact = _batches(PrefetchLoader(FMRIDataset(study), batch_size=5, shuffle=shuffle,
                                        seed=3, device="cpu"), 1)
        assert any(not np.array_equal(a["volume"], b["volume"]) for a, b in zip(got, exact))


def test_bfloat16_wire_rounds_as_ml_dtypes():
    """torch's host cast to bfloat16 gives ml_dtypes' bytes (round to
    nearest even), ties and the volumes' [0, 1] range included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 100000), rng.normal(size=1000) * 1e3,
                        # exact ties between two bfloat16 values
                        (np.arange(1, 2000, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
                        ]).astype(np.float32)
    loader = PrefetchLoader.__new__(PrefetchLoader)
    loader._wire = torch.bfloat16
    got = loader._host_wire(x).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).view(np.int16))


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_wide_eval_view_keeps_the_prefetch_wire(study, wire):
    """An unshuffled prefetch loader of the wider width on the same wire,
    with the JAX view's batches."""
    mine = wide_eval_view(PrefetchLoader(FMRIDataset(study), 5, shuffle=True, seed=3,
                                         transfer_dtype=wire, device="cpu"),
                          int(np.prod(SMALL_SHAPE)), width=8)
    theirs = jax_wide_eval_view(JaxPrefetchLoader(JaxDataset(study), 5, shuffle=True, seed=3,
                                                  transfer_dtype=wire),
                                int(np.prod(SMALL_SHAPE)), width=8)
    assert isinstance(mine, PrefetchLoader) and mine.transfer_dtype == wire
    assert (mine.batch_size, mine.shuffle, mine.device) == (8, False, torch.device("cpu"))
    _assert_same_batches(_batches(mine, 0), _batches(theirs, 0))


def test_mesh_and_row_sharding_are_refused(study):
    """Row sharding under a multi-process mesh is refused, as JAX refuses
    it; alone it iterates JAX's rows [shard_index::num_shards], and a mesh
    alone is taken."""
    two_ranks = DataMesh(0, 2, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="multi-process mesh"):
        PrefetchLoader(FMRIDataset(study), mesh=two_ranks, num_shards=2)
    with pytest.raises(ValueError, match="multi-process mesh"):
        setup_prefetch_loaders(train_csv=study, test_csv=study, num_shards=2, mesh=two_ranks)
    assert PrefetchLoader(FMRIDataset(study), mesh=two_ranks).device == torch.device("cpu")
    mine = PrefetchLoader(FMRIDataset(study), 5, shard_index=1, num_shards=2, device="cpu")
    theirs = JaxPrefetchLoader(JaxDataset(study), 5, shard_index=1, num_shards=2)
    assert mine.num_samples == theirs.num_samples and len(mine) == len(theirs) == 2
    _assert_same_batches(_batches(mine, 0), _batches(theirs, 0))


def test_trainer_takes_prefetched_tensors_as_they_are(study):
    """A float32 model takes the loader's tensors untouched (no copy); a
    float64 model gets them cast on their device, as the JAX Trainer's
    _put_batch casts to the config's dtype."""
    batch = next(iter(PrefetchLoader(FMRIDataset(study), 5, device="cpu")))
    t32 = Trainer(VAEGAMConfig(**THIN), [[-1.0, 1.0]] * 6, enable_tb=False, device="cpu")
    covs, x = t32._put_batch(batch)
    assert covs is batch["covariates"] and x is batch["volume"]
    t64 = Trainer(VAEGAMConfig(**THIN, dtype=torch.float64, conv5_kernel=False),
                  [[-1.0, 1.0]] * 6, enable_tb=False, device="cpu")
    covs, x = t64._put_batch(batch)
    assert covs.dtype == x.dtype == torch.float64
    np.testing.assert_array_equal(x.numpy(), batch["volume"].numpy().astype(np.float64))


def test_cli_streams_past_the_cache_budget_on_the_float16_wire(study, tmp_path, capsys,
                                                               monkeypatch):
    """A one-byte cache budget with --stream_dtype float16: the CLI trains
    and tests an epoch from prefetch loaders on the float16 wire."""
    monkeypatch.setenv("VAEGAM_CACHE_MAX_BYTES", "1")
    t, loaders = main(["--train_csv", study, "--test_csv", study, "--save_dir",
                       str(tmp_path), "--batch-size", "5", "--nf", "2", "--num_latents", "8",
                       "--img_shape", *map(str, SMALL_SHAPE), "--device", "cpu",
                       "--no_outputs", "--epochs", "1", "--test_freq", "1",
                       "--log_figs_every", "0", "--stream_dtype", "float16"])
    assert "prefetch loader" in capsys.readouterr().out
    assert all(isinstance(loaders[k], PrefetchLoader) and
               loaders[k].transfer_dtype == "float16" for k in loaders)
    assert np.isfinite(t.loss["train"][0]) and np.isfinite(t.loss["test"][0])
