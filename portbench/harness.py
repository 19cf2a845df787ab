"""One run of one benchmark cell: set-up, the measured window, the check.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and the
limits of its check.  The run:

1. set-up, timed from process start: the study from the seed on the host
   (``study.py``), the weights from the seed on the card
   (``reference.make_params``), a ``vaegam_tpu_torch`` ``Trainer`` built as
   the train CLI builds it (its ``init_model`` runs) with those weights
   copied into its parameters, the loader the traffic names
   (``loaders/<name>.py``; the CLI's default is the device cache), the
   checked steps and one warm-up epoch.  The checked steps are the first
   three batches of the loader's epoch-0 order, one ``Trainer.train_epoch``
   each on a view of the same cache; after each, the program's loss,
   parameters and Adam moments are copied to the host.  The warm-up epoch
   builds conv5, runs cuDNN's search for every batch width of the epoch
   and, under ``epoch_scan``, captures each width's graph;
2. the window: whole epochs of ``Trainer.train_epoch``, until the first
   that ends at or after ``--seconds``.  With ``--trace 1`` a second window
   of the same length follows under torch.profiler; the first one gives
   ``step_mfu_pct``, the traced one the device's metrics;
3. the peak memory is read, the program's state freed, and the plain
   reference (``reference.py``) takes each checked step from the state the
   program held before it, on the same rows and draws; ``check.py``
   compares.

The last line of standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import check, reference, study, trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vaegam_tpu")
CHECKED_STEPS = 3


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str):
    cell = load("workloads", name)
    return cell, load("configs", cell["config"]), load("traffic", cell["traffic"])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: ``vaegam_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def port_config(cfg: dict):
    """The configuration's fields that the port's ``VAEGAMConfig`` has, as
    it takes them (lists as tuples, dtype names as torch dtypes)."""
    from vaegam_tpu_torch.models import VAEGAMConfig

    fields = {}
    for f in dataclasses.fields(VAEGAMConfig):
        if f.name in cfg:
            v = cfg[f.name]
            if isinstance(v, list):
                v = tuple(v)
            elif f.name.endswith("dtype") and isinstance(getattr(torch, str(v), None),
                                                          torch.dtype):
                v = getattr(torch, v)
            fields[f.name] = v
    return VAEGAMConfig(**fields)


def _host(tree) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in reference.flatten(tree).items()}


def set_up(cfg: dict, traffic: dict, seed: int, device, warm_up: bool = True) -> dict:
    """Everything up to the window: returns the Trainer, the loader, the
    program's state after each checked step (``program``), what the
    reference needs and the seconds of each phase (``phases``)."""
    phases, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    from vaegam_tpu_torch.train import Trainer
    loaders = importlib.import_module(f"portbench.loaders.{traffic['loader']}")
    lap("import")
    s = study.seed_bits(seed)
    data = study.make_study(traffic, cfg["img_shape"], cfg["num_covariates"], s)
    lap("study")
    params0 = reference.flatten(reference.make_params(cfg, s, device))
    lap("weights")
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(port_config(cfg), data["xu_ranges"], glm_maps=data["glm_maps"],
                          save_dir="", lr=cfg["lr"], seed=s, log_figs_every=0,
                          enable_tb=False, epoch_scan=traffic["epoch_scan"], device=device)
    if cfg["tf32"]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    lap("trainer")
    with torch.no_grad():
        for k, leaf in reference.flatten(trainer.params).items():
            leaf.copy_(params0[k])
    p0 = {k: v.cpu() for k, v in params0.items()}
    del params0
    lap("weights_in")
    loader = loaders.build(data, traffic, s, device)
    lap("cache")
    program = []
    with contextlib.redirect_stdout(sys.stderr):
        for k in range(CHECKED_STEPS):
            view = loaders.one_batch(loader, k, s)
            mean = trainer.train_epoch(view)
            program.append({"loss": mean * view.num_samples, "params": _host(trainer.params),
                            "mu": _host(trainer.opt_state["mu"]),
                            "nu": _host(trainer.opt_state["nu"])})
    lap("checked_steps")
    if warm_up:
        with contextlib.redirect_stdout(sys.stderr):
            trainer.train_epoch(loader)
        lap("warm_up_epoch")
    return {"trainer": trainer, "loader": loader, "program": program, "params0": p0,
            "data": data, "seed": s, "phases": phases,
            "setup_epochs_s": sum(trainer.epoch_seconds.values())}


def checked_inputs(cfg: dict, traffic: dict, state: dict, device, dtype=torch.float32,
                   rows=None):
    """The checked steps' (covariates, volumes) and draws, worked out by the
    reference: the device cache's epoch-0 order, the Trainer's generator
    re-seeded.  ``rows`` keeps that many rows of each batch (a fault: half
    a batch)."""
    data, s, b = state["data"], state["seed"], traffic["batch_size"]
    order = reference.epoch_order(len(data["volumes"]), s, 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    batches, noises = [], []
    for k in range(CHECKED_STEPS):
        sel = order[k * b:(k + 1) * b]
        noise = reference.draw_noise(gen, len(sel), cfg, device)
        if rows is not None:
            sel, noise = sel[:rows], (noise[0][:rows], noise[1][:rows], noise[2][:, :rows])
        batches.append((torch.as_tensor(data["covariates"][sel], device=device).to(dtype),
                        torch.as_tensor(data["volumes"][sel], device=device).to(dtype)))
        noises.append(tuple(n.to(dtype) for n in noise))
    return batches, noises


def consts(cfg: dict, state: dict, device, dtype=torch.float32) -> dict:
    data = state["data"]
    return reference.make_consts(cfg, data["xu_ranges"], data["glm_maps"], device, dtype)


def judge(cfg: dict, traffic: dict, state: dict, side: list, device) -> list:
    """The reference's step k from `side`'s state before its step k."""
    batches, noises = checked_inputs(cfg, traffic, state, device)
    starts = [reference.fresh_state(state["params0"])] + side[:-1]
    return reference.follow(starts, consts(cfg, state, device), batches, noises, cfg,
                            cfg["lr"], device)


def compare(cfg: dict, traffic: dict, state: dict, side: list, device) -> dict:
    """The check's numbers for `side` (the program's state after each
    checked step, or a stand-in's)."""
    return check.compare(side, judge(cfg, traffic, state, side, device),
                         reference.fresh_state(state["params0"]))


def free(state: dict, device) -> None:
    """Drop the program's state (Trainer, its graphs and pool, the cache)."""
    state.pop("trainer", None)
    state.pop("loader", None)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def window(trainer, loader, seconds: float, widths_of_epoch: list) -> dict:
    """Whole epochs of ``train_epoch`` until one ends at or after `seconds`."""
    skipped0 = int(trainer.opt_state["total_notfinite"])
    epochs, epoch_s = 0, []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        while True:
            e0 = time.perf_counter()
            trainer.train_epoch(loader)   # ends in a host read of the losses
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            epochs += 1
            t = time.perf_counter()
            epoch_s.append(t - e0)
            if t - t0 >= seconds:
                break
    widths = widths_of_epoch * epochs
    return {"epochs": epochs, "window_s": t - t0, "epoch_s": epoch_s, "widths": widths,
            "steps": len(widths), "vols_per_s": sum(widths) / (t - t0),
            "failed": int(trainer.opt_state["total_notfinite"]) - skipped0}


def read_metrics(names, summary: dict) -> dict:
    """Each per-layer metric from its reader, ``metrics/<name>.py``; a
    reader that finds nothing to read returns None and is left out."""
    out = {}
    for name, unit in names:
        value = importlib.import_module(f"portbench.metrics.{name}").read(summary)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def per_layer_metrics(cell_name: str) -> list:
    """(name, unit) of each per-layer metric that ``BENCHMARK.json`` asks
    of the cell: those that list it, and those that list no cells."""
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device="cuda", t_start=None) -> dict:
    """One run; returns the result object (the ``compared`` key last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_import = time.perf_counter()
    state = set_up(cfg, traffic, seed, device)
    trainer, loader = state["trainer"], state["loader"]
    setup_s = time.perf_counter() - t_start
    print("portbench: set-up s " + " ".join(
        f"{k} {v:.3f}" for k, v in {"start": t_import - t_start, **state["phases"]}.items()),
        file=sys.stderr)

    epoch_widths = study.batch_widths(len(state["data"]["volumes"]), traffic["batch_size"])
    win = window(trainer, loader, seconds, epoch_widths)
    wins = [win]
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        wins.append(window(trainer, loader, seconds, epoch_widths))
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = {"cfg": cfg, "traffic": traffic, "window": win,
               "traced": wins[-1] if traced else None,
               "setup_epochs_s": state["setup_epochs_s"],
               "cache_upload_s": loader.build_seconds.get("upload"), "trace": None}
    free(state, device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}")

    if prof is not None:
        t0 = time.perf_counter()
        summary["trace"] = trace.summarize(*trace.records(prof))
        del prof
        print(f"portbench: trace read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    numbers = compare(cfg, traffic, state, state["program"], device)
    limits = cell["limits"]
    correct = check.verdict(numbers, limits)
    d = numbers["detail"]
    print("portbench: " + "; ".join(
        f"window {i}: epochs {w['epochs']}, {w['vols_per_s']:.4f} vols/s, epoch s "
        + " ".join(f"{t:.4f}" for t in w["epoch_s"]) for i, w in enumerate(wins))
        + f"; set-up epochs {summary['setup_epochs_s']:.3f} s", file=sys.stderr)
    print(f"portbench: checked steps: loss gaps {d.get('loss_steps')}; median leaves: "
          f"grad {d.get('grad_median_steps')}, change {d.get('change_median_steps')}; "
          f"worst leaves: grad {d.get('grad_worst')}, change {d.get('change_worst')}; "
          f"left out of the change: {d.get('left_out')}", file=sys.stderr)

    result = {"correct": correct, "attempted": sum(w["steps"] for w in wins),
              "failed": sum(w["failed"] for w in wins)}
    if traced:
        result["metrics"] = read_metrics(per_layer_metrics(cell["name"]), summary)
    else:
        result["metrics"] = {
            "train_vols_per_s": {"value": win["vols_per_s"], "unit": "vols/s"},
            "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = device_info(device, peak)
    if traced and summary["trace"] is not None:
        result["device"]["busy_s"] = summary["trace"]["busy_s"]
        result["device"]["window_s"] = wins[-1]["window_s"]
        result["breakdown"] = {"device_ops": summary["trace"]["device_ops"],
                               "idle_gaps": summary["trace"]["idle_gaps"]}
    result["compared"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return result


def device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    return x


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, traffic = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                 "cuda", t_start)
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    print(json.dumps(_json_safe(result)))
    return 0
