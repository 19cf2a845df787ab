"""Readings that set a cell's limits: the program over many seeds, the
control and the planted faults over a few, at the cell's own size; and the
look at what float32 rounding alone does to the steps.

    python3 -m portbench.calibrate --workload NAME --seeds 1 2 ... \
        [--control_seeds 3] [--look_seeds 3] [--out DIR]

For each seed the program is set up as a run sets it up (its checked steps;
no warm-up epoch or window follows) and judged as a run judges it.  For
the first ``--control_seeds`` seeds three stand-ins take the program's
place, each its own three steps from the same start, judged the same way:
  * ``control``: the reference with TF32 products, one precision step
    below the configuration's float32 with TF32 off;
  * ``half_batch``: the reference on half of each batch's rows;
  * ``altered``: the reference with each step's loss (its answer) altered
    by 1e-3 where it is produced, and differentiated as altered.
A step that leaves the state unchanged reads 1 on ``change_gap`` by the
measure itself and needs no run.

The look, for the first ``--look_seeds`` seeds: the reference's own three
steps in float64, in float32, and in float32 on cuDNN's deterministic
algorithms (another summation order); each float32 side's trajectory
(the program's, the reference's, the deterministic one's, the control's)
is measured against the float64 one: every step's loss, every leaf's
gradient and change since the start.

Each reading goes to ``DIR/<workload>.jsonl``; a summary line per arm is
printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import check, harness, reference

ALTERED_BY = 1e-3


def _grads(records: list) -> list:
    """Each step's gradient: the reference's own, or the program's as its
    optimizer got it, from its first moments."""
    out, mu_prev = [], None
    for rec in records:
        if "grad" in rec:
            out.append(rec["grad"])
        else:
            prev = mu_prev or {k: torch.zeros_like(v) for k, v in rec["mu"].items()}
            out.append({k: (rec["mu"][k] - check.ADAM_B1 * prev[k]) / (1 - check.ADAM_B1)
                        for k in rec["mu"]})
        mu_prev = rec["mu"]
    return out


def trajectory_gaps(side: list, exact: list, params0: dict) -> list:
    """Per step: `side`'s loss gap to `exact`'s, and each leaf's gap of its
    gradient and of its change since the start (gaps of norms, as
    ``check``); the two sides each follow their own trajectory."""
    out = []
    for a, b, ga, gb in zip(side, exact, _grads(side), _grads(exact)):
        keys = sorted(gb)
        grad = check._leaf_gaps(check._norms(ga), check._norms(gb), keys)
        change = check._leaf_gaps(
            check._norms({k: a["params"][k].double() - params0[k].double() for k in keys}),
            check._norms({k: b["params"][k].double() - params0[k].double() for k in keys}),
            keys)
        out.append({"loss": check._rel(a["loss"], b["loss"]), "grad": grad, "change": change,
                    "grad_median": check._median(grad.values()),
                    "change_median": check._median(change.values()),
                    "grad_worst": check._worst(grad), "change_worst": check._worst(change)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--look_seeds", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/calibrate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell, cfg, traffic = harness.load_cell(args.workload)
    os.makedirs(args.out, exist_ok=True)
    arms = {}
    with open(os.path.join(args.out, f"{args.workload}.jsonl"), "w") as f:
        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            state = harness.set_up(cfg, traffic, seed, dev, warm_up=False)
            harness.free(state, dev)
            p0 = {k: v.to(dev) for k, v in state["params0"].items()}
            c32 = harness.consts(cfg, state, dev)
            full = harness.checked_inputs(cfg, traffic, state, dev)
            sides = {"program": state["program"]}
            if i < args.control_seeds:
                half = harness.checked_inputs(cfg, traffic, state, dev,
                                              rows=traffic["batch_size"] // 2)
                sides["control"] = reference.trajectory(p0, c32, *full, cfg, cfg["lr"],
                                                        tf32=True)
                sides["half_batch"] = reference.trajectory(p0, c32, *half, cfg, cfg["lr"])
                sides["altered"] = reference.trajectory(
                    p0, c32, *full, cfg, cfg["lr"], fault=lambda loss: loss * (1 + ALTERED_BY))
            for arm, side in sides.items():
                nums = harness.compare(cfg, traffic, state, side, dev)
                arms.setdefault(arm, []).append(nums)
                f.write(json.dumps({"seed": seed, "arm": arm, **nums,
                                    "losses": [r["loss"] for r in side]}) + "\n")
                f.flush()
            if i < args.look_seeds:
                t1 = time.perf_counter()
                p64 = {k: v.double() for k, v in p0.items()}
                exact = reference.trajectory(p64, harness.consts(cfg, state, dev, torch.float64),
                                             *harness.checked_inputs(cfg, traffic, state, dev,
                                                                     torch.float64),
                                             cfg, cfg["lr"])
                t64 = time.perf_counter() - t1
                look = {"program": state["program"],
                        "reference": reference.trajectory(p0, c32, *full, cfg, cfg["lr"]),
                        "deterministic": reference.trajectory(p0, c32, *full, cfg, cfg["lr"],
                                                              deterministic=True)}
                if "control" in sides:
                    look["control"] = sides["control"]
                p0h = state["params0"]
                for name, side in look.items():
                    f.write(json.dumps({"seed": seed, "look": name, "against": "float64",
                                        "steps": trajectory_gaps(side, exact, p0h),
                                        "losses": [r["loss"] for r in side],
                                        "exact_losses": [r["loss"] for r in exact],
                                        "float64_s": t64}) + "\n")
                f.write(json.dumps({"seed": seed, "look": "program", "against": "reference",
                                    "steps": trajectory_gaps(state["program"],
                                                             look["reference"], p0h)}) + "\n")
                f.flush()
                del exact, look
            print(f"seed {seed}: " + "; ".join(
                f"{arm} " + " ".join(f"{k} {arms[arm][-1][k]:.3e}" for k in check.NAMES)
                for arm in sides) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            del state, sides, p0, full
    for arm, rows in arms.items():
        print(json.dumps({"arm": arm, "seeds": len(rows),
                          **{f"{k}_max": max(r[k] for r in rows) for k in check.NAMES},
                          **{f"{k}_min": min(r[k] for r in rows) for k in check.NAMES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
