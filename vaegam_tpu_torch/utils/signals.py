"""Hemodynamic response function (numpy + scipy).

Same formula as ``vaegam_tpu.utils.signals.hrf`` (reference utils.py:22-36);
kept as its own copy because that module imports JAX.
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
