"""Nothing the benchmark loads is JAX's or the JAX package's.

In a fresh interpreter, importing the harness and building each cell's
objects up to the card (its configuration as the port's ``VAEGAMConfig``,
a slice of its study, its weights, a Trainer and the device cache, on the
CPU) must leave no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``vaegam_tpu``; the names are compared whole, so
``vaegam_tpu_torch`` passes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import harness, reference, study
from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.train import Trainer
for name in json.loads(sys.argv[2]):
    cell, cfg, tr = harness.load_cell(name)
    tr = dict(tr, subjects=1, vols_per_subject=2)
    data = study.make_study(tr, cfg["img_shape"], cfg["num_covariates"], 1)
    params = reference.make_params(cfg, 1, "cpu")
    consts = reference.make_consts(cfg, data["xu_ranges"], data["glm_maps"], "cpu")
    Trainer(harness.port_config(cfg), enable_tb=False, device="cpu", params=params,
            consts=consts, epoch_scan=tr["epoch_scan"])
    DeviceResidentLoader.from_arrays(data["volumes"], data["covariates"], device="cpu")
print(json.dumps(harness.forbidden_modules()))
"""


def test_no_jax_module_is_loaded():
    cells = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT), json.dumps(cells)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vaegam_tpu.models", sys)
    assert harness.forbidden_modules() == ["vaegam_tpu"]
