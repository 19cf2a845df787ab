"""The control-experiment oracle in arms, several runs at once on one card.

A study script beside the package, not part of it: it drives the port's
oracle pipeline (``vaegam_tpu_torch.tools.control_experiment``: the same
synthetic subject, add_signal, preproc, GLM regularizer, Trainer, recon,
averaged maps and recovery check, at every default) in these arms:

  fp32  the oracle as ``chip_smoke.py`` phase 7 runs it: float32, conv5
        through its CUDA kernel, batches gathered from the device cache;
  f64   a float64 model (JAX's partial float64: norm statistics and sigmoid
        in float32), conv5 off, fed by the host DataLoader;
  tf32  the fp32 arm with cuBLAS and cuDNN allowed TF32 (10-bit mantissa
        products, float32 sums) once the Trainer has set up the card: the
        reduced-precision float32 products an accelerator gives a dot or
        conv at XLA's DEFAULT precision, which the JAX package never
        raises (conv5's kernel stays full float32);
  tpu   the fp32 arm in the TPU's own product arithmetic, the one JAX's
        records were made in (``VAEGAMConfig(tpu_products=True)``, the
        ``ops.products`` module): both operands of every product of the
        step (convs, FC layers, the GP's and the composition's
        contractions, conv5's kernel on its one-pass path) rounded to
        bfloat16, the sums in float32, forward and backward.

Both arms see the same batches: the host loader and the device cache take
the same epoch-addressed shuffle, ``default_rng((seed, epoch))``; the
script checks that once at the first seed.  Each run is its own process
(its own cuDNN algorithm search); ``--procs`` of them share the card at
once.  Each run records every epoch's loss and task gain ``sa[0]`` and
ends with the tool's recovery metrics.  ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` and ``cudnn.deterministic`` (the
search stays on) and records a hash of the final parameters, so that two
runs at one seed can be held against each other bit for bit.

    python oracle_study.py --work_dir W --out OUT --arms fp32 f64 \\
        --seeds 1 2 3 4 5 6 7 8 --epochs 900 --procs 8
    python oracle_study.py --work_dir W --out OUT --arms tpu --seeds 1 ... 8

Prints one JSON line a run and a summary line; writes each run's JSON
(with its per-epoch trace) under ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def make_data(work_dir: str, img_shape, n_vols: int) -> str:
    """The oracle's single-subject data at its defaults; returns the CSV."""
    from vaegam_tpu_torch.cli import add_signal, preproc
    from vaegam_tpu_torch.tools.control_experiment import build_fake_subjects

    data_dir = os.path.join(work_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    build_fake_subjects(data_dir, 1, n_vols, seed=0, img_shape=img_shape)
    add_signal.main(["--root_dir", data_dir, "--intensity", "1000.0", "--shape", "simple",
                     "--img_shape", *map(str, img_shape)])
    return preproc.main(
        ["--data_dir", data_dir, "--save_dir", work_dir, "--control",
         "--control_int", "1000", "--set_tag", "TRAIN",
         "--nii_file_pattern", "*_ALTERED_simple_*.nii.gz",
         "--sex_info", os.path.join(data_dir, "sex_info.csv"),
         "--mot_file_pattern", "sub-A000*_desc-confounds_regressors_*.tsv"])


def same_batches(csv: str, seed: int, epochs: int = 3) -> bool:
    """Whether the host DataLoader and the device cache visit the same rows
    in the same batches over the first epochs (on the CPU)."""
    from vaegam_tpu_torch.data import setup_data_loaders, setup_device_loaders

    host = setup_data_loaders(batch_size=32, train_csv=csv, test_csv=csv,
                              seed=seed)["Shuffled_train"]
    dev = setup_device_loaders(batch_size=32, train_csv=csv, test_csv=csv, seed=seed,
                               device="cpu")["Shuffled_train"]
    for epoch in range(epochs):
        host.set_epoch(epoch)
        dev.set_epoch(epoch)
        a = [b["vol_num"].tolist() for b in host]
        b = [dev._vol_nums[sel].tolist() for sel in dev.iter_index_batches()]
        if a != b:
            return False
    return True


def run_one(arm: str, seed: int, epochs: int, csv: str, run_dir: str,
            deterministic: bool, img_shape, device: str) -> dict:
    """One oracle run of `arm` at `seed`, as control_experiment.main trains
    it, epoch by epoch."""
    from vaegam_tpu_torch.data import setup_data_loaders, setup_device_loaders
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.outputs import mk_avg_maps, mk_single_volumes
    from vaegam_tpu_torch.tools.control_experiment import build_glm_maps, recovery_metrics
    from vaegam_tpu_torch.train import Trainer
    from vaegam_tpu_torch.utils import nifti
    from vaegam_tpu_torch.utils.stats import get_xu_ranges
    from vaegam_tpu_torch.utils.tree import tree_items

    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
    kw = dict(glm_reg_scale=1.0, neural_covariates=False, img_shape=img_shape,
              qu_s_cholesky=True, fused_norm_stats=True)
    if arm in ("fp32", "tf32", "tpu"):
        config = VAEGAMConfig(tpu_products=arm == "tpu", **kw)
        loaders = setup_device_loaders(batch_size=32, train_csv=csv, test_csv=csv,
                                       seed=seed, device=device)
    elif arm == "f64":
        config = VAEGAMConfig(dtype=torch.float64, conv5_kernel=False, **kw)
        loaders = setup_data_loaders(batch_size=32, train_csv=csv, test_csv=csv, seed=seed)
    else:
        raise ValueError(f"arm {arm!r}")
    trainer = Trainer(config, get_xu_ranges([csv, csv]),
                      glm_maps=build_glm_maps(1000.0, img_shape), save_dir=run_dir,
                      seed=seed, enable_tb=False, device=device)
    if arm == "tf32":  # after the Trainer's configure_cuda_backends turned TF32 off
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    trace = []
    t0 = time.time()
    for _ in range(epochs):
        loss = trainer.train_epoch(loaders["Shuffled_train"])
        trace.append((loss, float(trainer.params["gp"]["sa"][0])))
    train_s = time.time() - t0
    digest = hashlib.sha256()
    for _, t in tree_items(trainer.params):
        digest.update(t.detach().cpu().numpy().tobytes())
    mk_single_volumes(loaders["UnShuffled_train"], trainer, csv, run_dir)
    mk_avg_maps(csv, trainer, run_dir, mk_motion_maps=False)
    avg = os.path.join(run_dir, "reconstructions", f"{trainer.epoch:03d}_avg_model_recons")
    task_map = np.array(nifti.load(os.path.join(avg, "task_avg.nii")).dataobj)
    rec = recovery_metrics(task_map, 1000.0, img_shape)
    shutil.rmtree(run_dir)  # ~0.3 GB of maps a run at the reference grid
    eps = [trainer.epoch_seconds[k] for k in sorted(trainer.epoch_seconds)]
    return {"arm": arm, "seed": seed, "epochs": epochs, "deterministic": deterministic,
            "recovered": rec["recovered"], "inside_mean": rec["inside_mean"],
            "contrast": rec["contrast"], "final_loss": trace[-1][0],
            "final_sa_task": trace[-1][1],
            "skips": int(trainer.opt_state["total_notfinite"]),
            "fallbacks": trainer.mvn_fallbacks, "train_s": train_s,
            "epoch_s_median": float(np.median(eps[1:] if len(eps) > 1 else eps)),
            "params_sha256": digest.hexdigest(), "trace": trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--out", required=True, help="directory for each run's JSON")
    ap.add_argument("--arms", nargs="+", default=["fp32", "f64"])
    ap.add_argument("--seeds", nargs="+", type=int, default=list(range(1, 9)))
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of each arm and seed (two, to test repeatability)")
    ap.add_argument("--epochs", type=int, default=900)
    ap.add_argument("--procs", type=int, default=1, help="runs at once on the card")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--img_shape", type=int, nargs=3, default=[41, 49, 35],
                    help="volume grid (a smaller one only to rehearse on the CPU)")
    ap.add_argument("--n_vols", type=int, default=98)
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse")
    ap.add_argument("--child", nargs=3, metavar=("ARM", "SEED", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out)
    csv_path = Path(args.work_dir) / "oracle.csv"

    if args.child:
        arm, seed, tag = args.child[0], int(args.child[1]), args.child[2]
        run_dir = str(Path(args.work_dir) / f"{arm}_{seed}_{tag}")
        result = run_one(arm, seed, args.epochs, csv_path.read_text().strip(), run_dir,
                         args.deterministic, tuple(args.img_shape), args.device)
        (out / f"{arm}_{seed}_{tag}.json").write_text(json.dumps(result))
        return 0

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the study runs on the card")
    os.makedirs(args.work_dir, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if args.device == "cuda":
        from vaegam_tpu_torch.ops import build

        build.build("conv5")  # once, before the runs load it
    csv = make_data(args.work_dir, tuple(args.img_shape), args.n_vols)
    csv_path.write_text(csv)
    print(f"oracle data in {time.time() - t0:.1f} s; host DataLoader and device cache "
          f"visit the same batches at seed {args.seeds[0]} over 3 epochs: "
          f"{same_batches(csv, args.seeds[0])}", flush=True)

    jobs = [(arm, seed, str(r)) for r in range(args.repeats) for seed in args.seeds
            for arm in args.arms]
    running, results, failed = [], [], []
    log_dir = out / "logs"
    log_dir.mkdir(exist_ok=True)
    base = [sys.executable, os.path.abspath(__file__), "--work_dir", args.work_dir,
            "--out", str(out), "--epochs", str(args.epochs), "--device", args.device,
            "--img_shape", *map(str, args.img_shape)]
    if args.deterministic:
        base.append("--deterministic")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8") if args.deterministic \
        else dict(os.environ)
    try:
        while jobs or running:
            while jobs and len(running) < args.procs:
                arm, seed, tag = jobs.pop(0)
                log = open(log_dir / f"{arm}_{seed}_{tag}.log", "w")
                proc = subprocess.Popen(base + ["--child", arm, str(seed), tag],
                                        stdout=log, stderr=subprocess.STDOUT, env=env)
                running.append((proc, log, (arm, seed, tag)))
            time.sleep(2)
            for item in list(running):
                proc, log, (arm, seed, tag) = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                log.close()
                path = out / f"{arm}_{seed}_{tag}.json"
                if proc.returncode != 0 or not path.exists():
                    failed.append((arm, seed, tag, proc.returncode))
                    print(f"run {arm} seed {seed} #{tag} FAILED (exit {proc.returncode}); "
                          "its log's tail:\n" + "\n".join(
                              (log_dir / f"{arm}_{seed}_{tag}.log").read_text()
                              .splitlines()[-15:]), flush=True)
                    continue
                r = json.loads(path.read_text())
                results.append(r)
                print(json.dumps({k: v for k, v in r.items() if k != "trace"}), flush=True)
    finally:
        for proc, log, _ in running:
            proc.kill()
            proc.wait()
            log.close()
    summary = {arm: f"{sum(r['recovered'] for r in results if r['arm'] == arm)} of "
                    f"{sum(r['arm'] == arm for r in results)} recovered"
               for arm in args.arms}
    # repeats at one arm and seed: equal bit for bit (every epoch's loss and
    # task gain, and the final parameters)?
    repeat = {}
    for arm in args.arms:
        for seed in args.seeds:
            runs = [r for r in results if (r["arm"], r["seed"]) == (arm, seed)]
            if len(runs) > 1:
                repeat[f"{arm}_{seed}"] = all(
                    r["trace"] == runs[0]["trace"] and
                    r["params_sha256"] == runs[0]["params_sha256"] for r in runs)
    print(json.dumps({"summary": summary, "repeats_equal": repeat, "failed": failed,
                      "seconds": time.time() - t0}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
