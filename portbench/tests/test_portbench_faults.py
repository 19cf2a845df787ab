"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (``harness.run`` on the CPU at a thin
width, which skips the run's look for a card) with one fault planted in
the program, once eager and once under ``epoch_scan``, and holds the
cell's own limits.  The faults a one-chip training cell can have:
  * a step that returns its state unchanged (the optimizer applies
    nothing);
  * half of the batch left out, the mean taken over the rest (the device
    cache hands each step half of its batch's rows);
  * an answer altered where it is produced (the step's loss scaled by
    1 + 1e-3 in the forward, and differentiated as scaled).
"""

import pytest
from conftest import thin_cell

from portbench import harness

SEED = 2**31 + 11


def _no_update(monkeypatch):
    from vaegam_tpu_torch.train import loop

    monkeypatch.setattr(loop.Trainer, "_apply_gradients", lambda self, grads: None)


def _half_batch(monkeypatch):
    from vaegam_tpu_torch.data import device_cache

    batches = device_cache.DeviceResidentLoader.iter_index_batches
    monkeypatch.setattr(device_cache.DeviceResidentLoader, "iter_index_batches",
                        lambda self: (sel[:max(1, len(sel) // 2)] for sel in batches(self)))


def _altered_loss(monkeypatch):
    from vaegam_tpu_torch.train import loop

    forward = loop.forward

    def altered(*args, **kwargs):
        loss, aux = forward(*args, **kwargs)
        return loss * (1 + 1e-3), aux

    monkeypatch.setattr(loop, "forward", altered)


@pytest.mark.parametrize("seed", [SEED, 5 * 2**32 + 13], ids=["seed31", "seed34"])
@pytest.mark.parametrize("scan", [False, True], ids=["eager", "scan"])
def test_a_sound_run_is_correct(scan, seed):
    # a seed past 32 bits too: the Trainer's PRNG key holds 32
    cell, cfg, tr = thin_cell(epoch_scan=scan)
    result = harness.run(cell, cfg, tr, seed, 0.1, False, device="cpu")
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("scan", [False, True], ids=["eager", "scan"])
@pytest.mark.parametrize("fault", [_no_update, _half_batch, _altered_loss],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, scan):
    fault(monkeypatch)
    cell, cfg, tr = thin_cell(epoch_scan=scan)
    result = harness.run(cell, cfg, tr, SEED, 0.1, False, device="cpu")
    assert not result["correct"], result["compared"]
