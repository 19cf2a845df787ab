"""The comparison that decides ``correct``: the program's first train steps
against the plain reference, step by step.

The reference follows the program: its step k starts from the state that
the program held before its step k (the start: the initial parameters and
zero moments) and runs on the same rows and draws.  Per step and per leaf,
a gap of norms: | |program| - |reference| | over the larger of the
reference leaf's norm and the median leaf's.  Three numbers, each the
largest over the steps:
  * ``loss_gap``: the step's loss, |program - reference| / |reference|;
  * ``grad_gap``: the median leaf's gap of the step's gradient as the
    optimizer got it, worked out from the program's first moments before
    and after the step ((mu_k - b1 mu_{k-1}) / (1 - b1));
  * ``change_gap``: the median leaf's gap of the step's change of the
    parameters; leaves whose reference gradient is under a thousandth of
    the median leaf's move under Adam by rounding alone and are left out.
The worst leaves are reported beside them (``detail``): the GP's
kernel-scale gradients are a float32 cancellation that rounding alone
moves (PERF.md, "How correct is decided").
"""

from __future__ import annotations

import math

import torch

ADAM_B1 = 0.9
ROUNDOFF_SHARE = 1e-3
NAMES = ("loss_gap", "grad_gap", "change_gap")


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _median(values) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
    floor = _median([want[k] for k in keys]) if keys else 0.0

    def gap(a, b):
        scale = max(b, floor)
        if scale > 0 or math.isnan(scale):
            return abs(a - b) / scale
        return 0.0 if a == b else float("inf")

    return {k: gap(got[k], want[k]) for k in keys}


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|; two equal losses, or two NaN losses (a step that both
    sides' guards drop), agree."""
    if a == b or (math.isnan(a) and math.isnan(b)):
        return 0.0
    return abs(a - b) / abs(b) if b else float("inf")


def _worst(gaps: dict):
    if not gaps:
        return None, 0.0
    k = max(gaps, key=lambda k: (math.isnan(gaps[k]), gaps[k]))
    return k, gaps[k]


def _median_or_nan(gaps: dict) -> float:
    v = list(gaps.values())
    if not v or any(math.isnan(x) for x in v):
        return float("nan")
    return _median(v)


def _largest(values) -> float:
    values = list(values)
    if not values or any(math.isnan(x) for x in values):
        return float("nan")
    return max(values)


def step_gaps(before: dict, after: dict, ref: dict) -> dict:
    """One step's gaps.  ``before`` and ``after``: the program's state
    around its step, {"params", "mu"} by path, and its step's "loss";
    ``ref``: the reference's ``adam_step`` record from ``before``."""
    paths = sorted(ref["grad"])
    out = {"loss": _rel(after["loss"], ref["loss"]), "grad": {}, "change": {}}
    g_ref = _norms(ref["grad"])
    if ref["applied"]:
        g_got = _norms({k: (after["mu"][k] - ADAM_B1 * before["mu"][k]) / (1.0 - ADAM_B1)
                        for k in paths})
        out["grad"] = _leaf_gaps(g_got, g_ref, paths)
        floor = _median([g_ref[k] for k in paths])
        moving = [k for k in paths if g_ref[k] >= ROUNDOFF_SHARE * floor]
    else:   # a step the guard drops: the program has to apply nothing either
        moving = paths
    out["change"] = _leaf_gaps(
        _norms({k: after["params"][k] - before["params"][k] for k in moving}),
        _norms({k: ref["params"][k] - before["params"][k] for k in moving}), moving)
    out["left_out"] = [k for k in paths if k not in moving]
    return out


def compare(program: list, judged: list, start: dict) -> dict:
    """``program``: the program's state after each checked step, {"loss",
    "params", "mu"} by path; ``judged``: the reference's step k from the
    program's state before it (``reference.follow``); ``start``: the state
    before the first step (``reference.fresh_state``).  Returns the three
    numbers and ``detail``: each step's loss gap, median and worst leaves."""
    if len(program) != len(judged):
        nan = float("nan")
        return {"loss_gap": nan, "grad_gap": nan, "change_gap": nan, "detail": {}}
    steps = [step_gaps(b, a, r) for b, a, r in zip([start] + program[:-1], program, judged)]
    detail = {"loss_steps": [s["loss"] for s in steps],
              "grad_median_steps": [_median_or_nan(s["grad"]) if s["grad"] else 0.0
                                    for s in steps],
              "change_median_steps": [_median_or_nan(s["change"]) for s in steps],
              "grad_worst": [_worst(s["grad"]) for s in steps],
              "change_worst": [_worst(s["change"]) for s in steps],
              "left_out": sorted({k for s in steps for k in s["left_out"]}),
              "grad": [s["grad"] for s in steps], "change": [s["change"] for s in steps]}
    return {"loss_gap": _largest(detail["loss_steps"]),
            "grad_gap": _largest(detail["grad_median_steps"]),
            "change_gap": _largest(detail["change_median_steps"]),
            "detail": detail}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a NaN never is)."""
    return all(numbers[k] <= limit for k, limit in limits.items())
