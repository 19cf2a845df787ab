"""The benchmark's files: BENCHMARK.json against the configurations, cells,
traffic mixes and metric readers it names, and the yardstick's sources."""

import ast
import importlib
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
YARDSTICK = ("reference.py", "flops.py", "check.py", "study.py", "trace.py")


def test_every_configuration_and_cell_parses():
    from portbench import harness, reference

    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(reference.SUPPORTED) <= set(cfg)
    for w in BENCH["workloads"]:
        cell, cfg, traffic = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert set(cell["limits"]) <= {"loss_gap", "grad_gap", "change_gap"}
        loader = importlib.import_module(f"portbench.loaders.{traffic['loader']}")
        assert callable(loader.build) and callable(loader.one_batch)
        harness.port_config(cfg)


def test_every_metric_has_a_reader():
    from portbench import harness

    for w in BENCH["workloads"]:
        assert harness.per_layer_metrics(w["name"])
    for m in BENCH["per_layer"]:
        assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert {e["name"] for e in BENCH["end_to_end"]} == {
        "train_vols_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "portbench" / name).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert not imported & {"vaegam_tpu", "vaegam_tpu_torch", "jax", "jaxlib", "flax"}
