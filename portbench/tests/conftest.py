"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of a checkout (the card's tests carry the ``cuda`` marker and skip
without a card)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


THIN = {"nf": 2, "num_latents": 8, "img_shape": [21, 25, 21]}


def thin_cell(name="ref41-train-eager", **traffic):
    """A cell at a thin width and a small study (26 volumes, batch 8: three
    full steps and a tail of 2), with the cell's own limits."""
    from portbench import harness

    cell, cfg, tr = harness.load_cell(name)
    tr = dict(tr, subjects=2, vols_per_subject=13, batch_size=8, **traffic)
    return cell, dict(cfg, **THIN), tr
