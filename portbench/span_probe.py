"""A traced run of one cell with the program's spans on.

    python3 -m portbench.span_probe --workload NAME --seed N --seconds S

It runs the cell as ``run.py --trace 1`` does (the harness's set-up and
windows), with the program's span recorder (``vaegam_tpu_torch.utils.spans``)
switched as follows:

1. on from the start of set-up (``new_width_s`` reads set-up's spans);
2. off for the first window, as in the harness's runs (``step_mfu_pct``
   and the first window's vols/s read the same code as there);
3. the spans window, of the same length: spans on and no profiler (the
   host's span times, and the spans' cost when on: its vols/s against
   the first window's);
4. the profiled window, spans on: ``span_trace.attribute`` lays them over
   the trace.

The last line of standard output is one JSON object: the cell's per-layer
metrics as the traced run reads them, the span metrics of ``SPAN_METRICS``
that list the cell, the three windows, the device's breakdown with
``idle_by_span`` beside ``device_ops`` and ``idle_gaps`` (read as the
harness reads them: the spans' ``record_function`` rows, on the CPU and
the device, are left out of the trace), and per span name its numbers a
step.  It runs no
check: ``run.py`` does.  The program has to have the span recorder.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import Counter

import torch

from . import harness, span_trace, study, trace

# the per-layer metrics that read the spans, as BENCHMARK.json's entries
# would give them (each reader is metrics/<name>.py)
EAGER, SCAN = "ref41-train-eager", "ref41-train-scan"
_STEP, _DRIVER = "model step, stock kernels", "epoch driver, optimizer, graphs"
SPAN_METRICS = [
    {"name": "fwd_device_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": _STEP, "moves": "train_vols_per_s", "workloads": [EAGER]},
    {"name": "bwd_device_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": _STEP, "moves": "train_vols_per_s", "workloads": [EAGER]},
    {"name": "adam_device_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": _DRIVER, "moves": "train_vols_per_s", "workloads": [EAGER]},
    {"name": "adam_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": _DRIVER, "moves": "train_vols_per_s", "workloads": [EAGER]},
    {"name": "launches_per_step", "unit": "launches", "better": "lower",
     "source": "device_trace", "layer": _DRIVER, "moves": "train_vols_per_s",
     "workloads": [EAGER, SCAN]},
    {"name": "host_syncs_per_step", "unit": "syncs", "better": "lower",
     "source": "device_trace", "layer": "device cache", "moves": "train_vols_per_s",
     "workloads": [EAGER, SCAN]},
    {"name": "new_width_s", "unit": "s", "better": "lower", "source": "program_span",
     "layer": _DRIVER, "moves": "setup_s", "workloads": [EAGER, SCAN]},
]
STEP_PARTS = ("step.gather", "step.forward", "step.backward", "step.adam")


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        device="cuda") -> dict:
    from torch.profiler import ProfilerActivity, profile
    from vaegam_tpu_torch.utils import spans

    on_card = torch.device(device).type == "cuda"
    spans.reset()
    spans.enable()
    state = harness.set_up(cfg, traffic, seed, device)
    trainer, loader = state["trainer"], state["loader"]
    setup = spans.records()
    spans.disable()
    spans.reset()
    widths = study.batch_widths(len(state["data"]["volumes"]), traffic["batch_size"])

    first = harness.window(trainer, loader, seconds, widths)
    spans.enable()
    spanned = harness.window(trainer, loader, seconds, widths)
    window_spans = spans.records()
    spans.reset()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        traced = harness.window(trainer, loader, seconds, widths)
    traced_spans = spans.records()
    spans.disable()
    spans.reset()
    upload_s = loader.build_seconds.get("upload")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del trainer, loader
    harness.free(state, device)

    t0 = time.perf_counter()
    dev, cpu = span_trace.kineto_records(prof, drop={s[0] for s in traced_spans})
    del prof
    at = span_trace.attribute(traced_spans, dev, cpu)
    summary = {
        "cfg": cfg, "traffic": traffic, "window": first, "traced": traced,
        "setup_epochs_s": state["setup_epochs_s"],
        "cache_upload_s": upload_s,
        "trace": trace.summarize(
            [(s * 1e-3, e * 1e-3, n) for s, e, n, *_ in dev],
            [(s * 1e-3, e * 1e-3, n) for s, e, n, _ in cpu
             if not n.startswith("PyTorch Profiler")]),
        "spans": {"setup": setup, "window": span_trace.attribute(window_spans)},
        "span_trace": at,
    }
    read_s = time.perf_counter() - t0
    metric_names = harness.per_layer_metrics(cell["name"]) + [
        (m["name"], m["unit"]) for m in SPAN_METRICS if cell["name"] in m["workloads"]]
    metrics = harness.read_metrics(metric_names, summary)

    steps = at["steps"]
    rows = {n: {k: v / steps for k, v in d.items()
                if k in ("host_self_ms", "device_self_ms", "launches_self", "syncs_self")}
            for n, d in at["by_name"].items()} if steps else {}
    kernel_ms = 1e3 * summary["trace"]["kernel_s"] / traced["steps"] if traced["steps"] else 0
    parts_ms = sum(at["by_name"].get(n, {}).get("device_ms", 0.0) for n in STEP_PARTS)
    cost = 100.0 * (1.0 - spanned["vols_per_s"] / first["vols_per_s"])
    print("portbench spans: per step (host self ms, device self ms, launches, syncs): "
          + "; ".join(f"{n} {r['host_self_ms']:.4f} {r['device_self_ms']:.4f} "
                      f"{r['launches_self']:.2f} {r['syncs_self']:.3f}"
                      for n, r in rows.items()), file=sys.stderr)
    print(f"portbench spans: first window {first['vols_per_s']:.4f} vols/s, spans window "
          f"{spanned['vols_per_s']:.4f} ({cost:.3f}% slower), traced "
          f"{traced['vols_per_s']:.4f}; trace read in {read_s:.1f} s", file=sys.stderr)
    return {
        "metrics": metrics,
        "windows": {k: {"vols_per_s": w["vols_per_s"], "epochs": w["epochs"],
                        "steps": w["steps"], "window_s": w["window_s"]}
                    for k, w in (("first", first), ("spans", spanned), ("traced", traced))},
        "spans_cost_pct": cost,
        "coverage": {
            "kernel_s": at["kernel_s"], "kernel_s_in_spans": at["kernel_s_in_spans"],
            "unlinked_kernels": at["unlinked_kernels"],
            "step_parts_ms": parts_ms / steps if steps else None,
            "kernel_ms_per_step": kernel_ms,
            "span_steps": steps, "window_steps": traced["steps"]},
        "per_step": rows,
        "kernels_by_name": {n: c / traced["steps"] for n, c in Counter(
            n for _, _, n, *_ in dev if span_trace.is_kernel(n)).most_common()}
        if traced["steps"] else {},
        "setup_phases": state["phases"],
        "breakdown": {"device_ops": summary["trace"]["device_ops"],
                      "idle_gaps": summary["trace"]["idle_gaps"],
                      "idle_by_span": at["idle_by_span"]},
        "device": harness.device_info(device, peak),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell, cfg, traffic = harness.load_cell(args.workload)
    with contextlib.redirect_stdout(sys.stderr):
        result = run(cell, cfg, traffic, args.seed, args.seconds, args.device)
    print(json.dumps(harness._json_safe(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
