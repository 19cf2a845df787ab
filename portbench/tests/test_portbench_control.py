"""The control on the card: the reference in TF32, one precision step below
the configuration's float32 with TF32 off, put in the program's place, must
fail a cell's limits where the program passes them.

At the cells' own widths and batch on a small study (three full steps and
a tail), so that the test fits a test run: the program's three checked
steps through ``Trainer.train_epoch`` and the control's own three, each
judged by the reference as a run judges the program.
The calibration at the cells' full studies is ``python3 -m
portbench.calibrate`` (PERF.md gives its readings).
"""

import pytest

from portbench import check, harness, reference


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ref41-train-eager", "ref41-train-scan"])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_the_control_fails_where_the_program_passes(card, name, seed):
    cell, cfg, tr = harness.load_cell(name)
    b = tr["batch_size"]
    tr = dict(tr, subjects=1, vols_per_subject=3 * b + 2)
    state = harness.set_up(cfg, tr, seed, card, warm_up=False)
    harness.free(state, card)
    p0 = {k: v.to(card) for k, v in state["params0"].items()}
    control = reference.trajectory(p0, harness.consts(cfg, state, card),
                                   *harness.checked_inputs(cfg, tr, state, card), cfg,
                                   cfg["lr"], tf32=True)
    limits = cell["limits"]
    assert check.verdict(harness.compare(cfg, tr, state, state["program"], card), limits)
    assert not check.verdict(harness.compare(cfg, tr, state, control, card), limits)
