"""The span trace reader (``span_trace.py``) on synthetic records, its
imports, the span metrics' readers, and the span probe on the CPU."""

import ast
import importlib
from pathlib import Path

import pytest

from portbench import span_probe, span_trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000


def _span(name, start, end, sid, parent=None, step=None, attrs=None):
    return (name, start * MS, end * MS, sid, parent, step, attrs)


# one epoch of two steps: an eager step (gather, forward, backward, adam)
# and a replayed one; times in ms
SPANS = [
    _span("train.step", 1, 40, 1, 0, (0, 0), {"width": 4, "kind": "eager",
                                              "first_at_width": True}),
    _span("step.gather", 1, 5, 2, 1, (0, 0)),
    _span("step.forward", 5, 15, 3, 1, (0, 0)),
    _span("ops.build", 6, 9, 7, 3, (0, 0)),
    _span("step.backward", 15, 30, 4, 1, (0, 0)),
    _span("step.adam", 30, 39, 5, 1, (0, 0)),
    _span("train.step", 40, 50, 6, 0, (0, 1), {"width": 4, "kind": "replay",
                                               "first_at_width": False}),
    _span("step.replay", 41, 49, 8, 6, (0, 1)),
    _span("train.epoch_sync", 50, 55, 9, 0, (0, None)),
    _span("train.epoch", 0, 56, 0, None, (0, None)),
]


def _cpu(name, t, corr):
    return (t * MS, t * MS + 1000, name, corr)


def _dev(name, start, end, corr, linked=0):
    return (start * MS, end * MS, name, corr, linked)


CPU = [
    _cpu("cudaMemcpyAsync", 2, 1), _cpu("cudaStreamSynchronize", 2.5, 2),
    _cpu("cudaLaunchKernel", 7, 3),                 # inside ops.build, in forward
    _cpu("cudaLaunchKernelExC", 16, 4),             # backward, autograd's thread
    _cpu("cudaLaunchKernel", 31, 5),
    _cpu("cudaGraphLaunch", 42, 6),
    _cpu("cudaLaunchKernel", 51, 7), _cpu("cudaMemcpyAsync", 52, 8),
    _cpu("cudaStreamSynchronize", 52.5, 9),
    _cpu("aten::mul", 57, 100),                      # an op outside every span
]
DEV = [
    _dev("Memcpy HtoD (Pageable -> Device)", 2, 2.2, 1),
    _dev("conv_fwd", 8, 12, 3),
    _dev("wgrad", 20, 28, 4),
    _dev("adam_kernel", 32, 33, 5),
    _dev("graph_kernel_a", 43, 45, 6), _dev("graph_kernel_b", 45, 48, 6),
    _dev("sum_kernel", 51.5, 52, 7),
    _dev("elementwise", 57.5, 58, 999, linked=100),   # found through its op
    _dev("orphan", 60, 61, 12345),
]


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    at = span_trace.attribute(SPANS, DEV, CPU)
    by = at["by_name"]
    assert by["ops.build"]["device_self_ms"] == pytest.approx(4.0)
    assert by["step.forward"]["device_self_ms"] == 0.0
    assert by["step.forward"]["device_ms"] == pytest.approx(4.0)
    assert by["step.backward"]["device_ms"] == pytest.approx(8.0)
    assert by["step.adam"]["device_ms"] == pytest.approx(1.0)
    assert by["step.replay"]["device_ms"] == pytest.approx(5.0)
    assert by["step.replay"]["kernels"] == 2
    assert by["train.step"]["device_ms"] == pytest.approx(18.0)
    assert by["train.epoch"]["device_ms"] == pytest.approx(18.5)
    assert at["kernel_s"] == pytest.approx(20.0e-3)
    assert at["kernel_s_in_spans"] == pytest.approx(18.5e-3)
    assert at["unlinked_kernels"] == 1
    assert at["steps"] == 2


def test_launches_and_syncs_are_counted_by_span():
    by = span_trace.attribute(SPANS, DEV, CPU)["by_name"]
    assert by["step.gather"]["launches"] == 1 and by["step.gather"]["syncs"] == 1
    assert by["train.step"]["launches"] == 5
    assert by["train.step"]["launches_self"] == 0
    assert by["step.replay"]["launches"] == 1
    assert by["train.epoch"]["launches"] == 7
    assert by["train.epoch"]["syncs"] == 2
    assert by["train.epoch_sync"]["syncs_self"] == 1
    assert span_trace.per_step({"steps": 2, "by_name": by}, "train.step", "launches") == 2.5
    assert span_trace.per_step({"steps": 0, "by_name": by}, "train.step", "launches") is None
    assert span_trace.per_step(None, "train.step", "launches") is None


def test_host_times_and_self_times():
    by = span_trace.attribute(SPANS)["by_name"]
    assert by["train.step"]["count"] == 2
    assert by["train.step"]["host_ms"] == pytest.approx(49.0)
    assert by["train.step"]["host_self_ms"] == pytest.approx(49.0 - 38.0 - 8.0)
    assert by["step.forward"]["host_self_ms"] == pytest.approx(7.0)
    assert by["train.epoch"]["host_self_ms"] == pytest.approx(56.0 - 49.0 - 5.0)


def test_an_idle_gap_is_named_by_its_span():
    at = span_trace.attribute(SPANS, DEV, CPU)
    idle = dict(at["idle_by_span"])
    # gaps: 2.2-8 (gather 2.2-5, forward's ops.build 6-8: middle 5.1 in forward),
    # 12-20 (middle 16, backward), 28-32 (30: adam), 33-43 (38: adam),
    # 48-51.5 (49.75: train.step), 52-57.5 (54.75: epoch_sync), 58-60 (no span)
    assert idle == pytest.approx({"step.forward": 5.8e-3, "step.backward": 8e-3,
                                  "step.adam": 14e-3, "train.step": 3.5e-3,
                                  "train.epoch_sync": 5.5e-3, span_trace.NO_SPAN: 2e-3})


def test_new_width_s_leaves_out_the_build():
    assert span_trace.new_width_s(SPANS) == pytest.approx((39 - 3) * 1e-3)
    assert span_trace.new_width_s(SPANS[1:6]) is None


def test_the_calls_it_counts():
    assert all(map(span_trace.is_launch, ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                          "cuLaunchKernel", "cuLaunchKernelEx",
                                          "cudaGraphLaunch", "cudaMemcpyAsync",
                                          "cudaMemsetAsync")))
    assert not span_trace.is_launch("cudaMemcpy")
    assert span_trace.is_sync("cudaMemcpy") and not span_trace.is_sync("cudaMemcpyAsync")


def test_span_trace_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "portbench" / "span_trace.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert imported <= {"__future__", "bisect", "re", "collections", "torch"}


@pytest.mark.parametrize("metric", span_probe.SPAN_METRICS, ids=lambda m: m["name"])
def test_every_span_metric_has_a_reader_and_its_cells(metric):
    from portbench import harness

    reader = importlib.import_module(f"portbench.metrics.{metric['name']}").read
    assert reader({}) is None   # a run without spans: nothing to read
    assert metric["workloads"]
    for name in metric["workloads"]:
        harness.load_cell(name)
    assert metric["moves"] in {"train_vols_per_s", "setup_s"}


def test_the_probe_runs_a_thin_cell_on_the_cpu():
    from conftest import thin_cell

    for name in (span_probe.EAGER, span_probe.SCAN):
        cell, cfg, tr = thin_cell(name)
        out = span_probe.run(cell, cfg, tr, 5, 0.5, device="cpu")
        m = out["metrics"]
        assert m["new_width_s"]["value"] > 0
        assert ("adam_host_ms" in m) == (name == span_probe.EAGER)
        assert out["coverage"]["span_steps"] == out["windows"]["traced"]["steps"]
        assert {"train.step", "step.forward", "step.backward", "step.adam",
                "train.epoch", "train.epoch_sync"} <= set(out["per_step"])


def test_kineto_records_leave_out_the_spans_rows():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe.span"):
            torch.ones(8).sum()
    _, cpu = span_trace.kineto_records(prof)
    assert "probe.span" in {r[2] for r in cpu}
    _, cpu = span_trace.kineto_records(prof, drop={"probe.span"})
    assert "probe.span" not in {r[2] for r in cpu} and cpu
