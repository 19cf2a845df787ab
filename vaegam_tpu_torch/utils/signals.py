"""Hemodynamic response function and stimulus series (numpy + scipy).

The port's own copy of the host-side functions of
``vaegam_tpu.utils.signals`` (that module imports JAX):
  * hrf:                        reference utils.py:22-36 (double-gamma, peak 0.6)
  * stimulus_to_neural:         reference utils.py:75-91 (20 s blocks, first OFF)
  * control_stimulus_to_neural: reference utils.py:93-111 (20 s blocks, first ON)
"""

from __future__ import annotations

import numpy as np
from scipy.stats import gamma as _scipy_gamma


def hrf(times):
    """Double-gamma canonical HRF sampled at `times` (seconds).

    peak  = Gamma(shape=6, scale=1) pdf
    under = Gamma(shape=12, scale=1) pdf
    hrf   = (peak - 0.35*under), normalized so max == 0.6
    """
    times = np.asarray(times, dtype=np.float64)
    peak_values = _scipy_gamma.pdf(times, 6)
    undershoot_values = _scipy_gamma.pdf(times, 12)
    values = peak_values - 0.35 * undershoot_values
    return values / np.max(values) * 0.6


def _block_series(vol_times, first_block_on: bool) -> np.ndarray:
    """Binary ON/OFF series over 20-second blocks.

    Block index b = floor(t/20).  With ``first_block_on=False`` (the checker
    task), even blocks (incl. b=0) are OFF and odd blocks are ON; inverted for
    control experiments.
    """
    t = np.asarray(vol_times) // 20
    even = (t % 2) == 0
    if first_block_on:
        return even.astype(np.int64)
    return (~even).astype(np.int64)


def stimulus_to_neural(vol_times):
    """Task series for the checker dataset: first 20 s block is NO-TASK."""
    return _block_series(vol_times, first_block_on=False)


def control_stimulus_to_neural(vol_times):
    """Task series for control (synthetic-signal) experiments: first block ON."""
    return _block_series(vol_times, first_block_on=True)
