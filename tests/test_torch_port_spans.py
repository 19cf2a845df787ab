"""The port's span recorder (``vaegam_tpu_torch.utils.spans``) on the CPU.

Off, a span site is the one shared no-op object and an epoch records
nothing.  On, an epoch on a thin device cache records the tree epoch >
step > gather / forward / backward / adam (eager) or noise / gather /
forward / backward / adam (``epoch_scan``, whose steps run eagerly on the
CPU), each child inside its parent, one step span a step with its step id,
width and kind; ``epoch_seconds`` is the epoch span's duration;
``first_at_width`` marks the first step at each width since ``reset``; a
span lies on torch.profiler's clock; the CLI's ``--profile_dir`` writes
``spans.json``.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
from vaegam_tpu_torch.cli.train import main
from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils import spans

from torch_port_common import THIN, XU_RANGES

N_VOLS, BATCH = 10, 4     # steps of 4, 4 and 2 rows


@pytest.fixture
def recorder():
    """The recorder cleared and on; off and cleared again afterwards."""
    spans.reset()
    spans.enable()
    yield spans
    spans.disable()
    spans.reset()


def _trainer(epoch_scan=False):
    return Trainer(VAEGAMConfig(**THIN), XU_RANGES, enable_tb=False, device="cpu",
                   seed=3, epoch_scan=epoch_scan)


def _loader(seed=0):
    rng = np.random.default_rng(seed)
    covs = rng.integers(0, 2, size=(N_VOLS, 8)).astype(np.float32)
    covs[:, 2:] = rng.normal(size=(N_VOLS, 6))
    vols = rng.uniform(size=(N_VOLS, *THIN["img_shape"])).astype(np.float32)
    return DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                            seed=seed, device="cpu")


def _check_epoch_tree(recs, trainer, epoch, children, kind):
    by_id = {r.id: r for r in recs}
    ep = [r for r in recs if r.name == "train.epoch" and r.step == (epoch, None)]
    assert len(ep) == 1
    ep = ep[0]
    assert trainer.epoch_seconds[epoch] == (ep.end_ns - ep.start_ns) * 1e-9
    steps = sorted((r for r in recs if r.name == "train.step" and r.parent == ep.id),
                   key=lambda r: r.step)
    assert [r.step for r in steps] == [(epoch, i) for i in range(3)]
    assert [r.attrs["width"] for r in steps] == [4, 4, 2]
    assert {r.attrs["kind"] for r in steps} == {kind}
    for s in steps:
        kids = sorted((r for r in recs if r.parent == s.id), key=lambda r: r.start_ns)
        assert [k.name for k in kids] == children
        assert all(k.step == s.step for k in kids)
    for r in recs:
        if r.parent is not None and r.parent in by_id:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r, p)
    assert [r.step for r in recs if r.name == "train.epoch_sync" and r.parent == ep.id] \
        == [(epoch, None)]


def test_off_records_nothing_and_shares_one_object():
    spans.disable()
    spans.reset()
    assert spans.span("step.forward") is spans.span("x") is spans.NO_SPAN
    assert spans.step(0, 0, 4, "eager") is spans.NO_SPAN
    t = _trainer()
    t.train_epoch(_loader())
    assert spans.records() == []
    assert t.epoch_seconds[0] > 0


@pytest.mark.parametrize("epoch_scan", [False, True], ids=["eager", "epoch_scan"])
def test_epoch_records_the_step_tree(recorder, epoch_scan):
    t = _trainer(epoch_scan)
    loader = _loader()
    t.train_epoch(loader)
    t.train_epoch(loader)
    recs = recorder.records()
    children = ["step.gather", "step.forward", "step.backward", "step.adam"]
    if epoch_scan:
        children = ["step.noise"] + children
    for epoch in (0, 1):
        _check_epoch_tree(recs, t, epoch, children, "eager")
    assert sum(r.name == "train.step" for r in recs) == 6


def test_first_at_width_once_per_width_after_reset(recorder):
    t = _trainer()
    loader = _loader()
    t.train_epoch(loader)
    t.train_epoch(loader)

    def firsts():
        return sorted((r.step, r.attrs["width"]) for r in recorder.records()
                      if r.name == "train.step" and r.attrs["first_at_width"])

    assert firsts() == [((0, 0), 4), ((0, 2), 2)]
    recorder.reset()
    t.train_epoch(loader)
    assert firsts() == [((2, 0), 4), ((2, 2), 2)]


def test_spans_lie_on_the_profilers_clock(recorder):
    """Each span opens its record_function before its first clock read and
    closes it after its last, so on one clock the profiler's event holds
    the span: within 100 us at both ends (the offset's error), however long
    the scheduler keeps the thread between the two."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # record_function's first calls set themselves up: one warm-up round
        for name in ("warm_up", "probe", "probe", "probe"):
            with spans.span(f"{name}.outer"):
                with spans.span(f"{name}.inner"):
                    torch.ones(64).sum()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("probe."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    mine = {}
    for r in recorder.records():
        if r.name.startswith("probe."):
            mine.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert sorted(events) == sorted(mine) == ["probe.inner", "probe.outer"]
    for name in mine:
        assert len(events[name]) == len(mine[name]) == 3
        for (s, e), (ps, pe) in zip(sorted(mine[name]), sorted(events[name])):
            assert ps - 100_000 < s < e < pe + 100_000
            assert s - ps < 10_000_000 and pe - e < 10_000_000   # the same event


def test_timed_reads_its_seconds_when_off():
    spans.disable()
    with spans.timed("cache.upload") as t:
        pass
    assert t.seconds >= 0 and spans.records() == []


def test_cli_profile_dir_writes_spans_json(tmp_path):
    root = str(tmp_path / "subjects")
    make_subject_tree(root, n_subjs=1, n_vols=6, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, os.path.join(root, "design.csv"))
    glm = os.path.join(root, "glm.csv")
    pd.DataFrame(np.random.default_rng(0).normal(size=(int(np.prod(SMALL_SHAPE)), 8))
                 ).to_csv(glm)
    prof_dir = tmp_path / "profile"
    main(["--train_csv", csv, "--test_csv", csv, "--glm_maps", glm,
          "--save_dir", str(tmp_path / "run"), "--batch-size", "4", "--nf", "2",
          "--num_latents", "8", "--img_shape", *map(str, SMALL_SHAPE), "--device", "cpu",
          "--no_outputs", "--epochs", "1", "--test_freq", "1",
          "--profile_dir", str(prof_dir)])
    assert not spans.enabled()
    assert (prof_dir / "trace.json").exists()
    recs = json.loads((prof_dir / "spans.json").read_text())
    names = {r["name"] for r in recs}
    assert {"cache.upload", "train.epoch", "train.step", "step.gather", "step.forward",
            "step.backward", "step.adam", "train.epoch_sync", "train.test_epoch"} <= names
    assert sorted(tuple(r["step"]) for r in recs if r["name"] == "train.step") == \
        [(0, 0), (0, 1)]
    with open(prof_dir / "trace.json") as f:
        trace = json.load(f)
    assert {"train.epoch", "train.step", "step.forward"} <= {
        e.get("name") for e in trace["traceEvents"]}
    spans.reset()
