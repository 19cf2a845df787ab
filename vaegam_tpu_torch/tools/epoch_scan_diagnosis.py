"""Does a long ``--epoch_scan`` run degrade?  A diagnosis harness for the
port's CUDA-graph replay.

Counterpart of ``vaegam_tpu.tools.epoch_scan_diagnosis``, re-aimed: the JAX
package's ``epoch_scan`` is one ``lax.scan`` dispatch a segment, the port's
a CUDA graph of the gather-fused step per batch width, replayed.  This tool
trains ``--epochs`` replayed epochs of synthetic MNI-grid volumes held on
the device (the JAX tool's MNI config: GLM maps, no HRF on the task gain,
joint norm statistics, Cholesky-parameterized GP covariances; batch 8) and
records, for each epoch:

  * its wall time, split into the host's return (the replays and the
    per-step bookkeeping enqueued) and the sync (reading the epoch's
    losses), so a slow return points at the host and a slow sync at the
    device;
  * every ``--probe_every`` epochs (and the first three), a probe: two
    eager train steps timed round trip (the minimum kept), so a slowdown
    seen by the probe too is global (allocator, host) and one seen by the
    replays alone is the graphs';
  * ``torch.cuda.memory_stats`` (allocated, reserved, allocation retries),
    the graphs' private pool, and the host's VmRSS.

``--mode per_step`` is the eager control arm (the same epochs without
replay).  The JAX tool's ``--no_donate`` and ``--segment_cap`` arms have no
counterpart: torch has no buffer donation, and a replay is one step, not a
segment.  The run stops early once an epoch is ``--abort_factor`` times the
median of epochs 5..19 for 5 epochs in a row.

    python -m vaegam_tpu_torch.tools.epoch_scan_diagnosis --epochs 300 \\
        --log scan_diag.jsonl

Writes one JSON record an epoch to ``--log`` when given, and prints one
JSON line at the end holding them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .._device import resolve_device
from .common import emit, graph_pool_mib, sync


def host_rss_mib() -> float:
    """This process's resident host memory, MiB (-1 where /proc says nothing)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def _memory(device) -> dict:
    rec = {"host_rss_mib": host_rss_mib()}
    if device.type == "cuda":
        ms = torch.cuda.memory_stats(device)
        rec.update(allocated_mib=ms.get("allocated_bytes.all.current", 0) / 2**20,
                   reserved_mib=ms.get("reserved_bytes.all.current", 0) / 2**20,
                   peak_allocated_mib=ms.get("allocated_bytes.all.peak", 0) / 2**20,
                   alloc_retries=ms.get("num_alloc_retries", 0),
                   graph_pool_mib=graph_pool_mib())
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--n_vols", type=int, default=98)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--img_shape", type=int, nargs=3, default=[91, 109, 91])
    p.add_argument("--nf", type=int, default=8)
    p.add_argument("--num_latents", type=int, default=32)
    p.add_argument("--mode", choices=["scan", "per_step"], default="scan",
                   help="scan: replayed epochs; per_step: the eager control arm")
    p.add_argument("--probe_every", type=int, default=10)
    p.add_argument("--log", type=str, default="")
    p.add_argument("--abort_factor", type=float, default=4.0)
    p.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..data import DeviceResidentLoader
    from ..models import VAEGAMConfig
    from ..train import Trainer

    img_shape = tuple(args.img_shape)
    rng = np.random.default_rng(0)
    vols = rng.uniform(0, 1, size=(args.n_vols,) + img_shape).astype(np.float32)
    covs = rng.normal(size=(args.n_vols, 8)).astype(np.float32)
    config = VAEGAMConfig(nf=args.nf, num_latents=args.num_latents, img_shape=img_shape,
                          glm_reg_scale=10.0, neural_covariates=False,
                          fused_norm_stats=True, qu_s_cholesky=True)
    glm = (rng.normal(size=(config.img_dim, 9)) * 0.01).astype(np.float32)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=args.batch_size,
                                              shuffle=True, seed=1, device=device)
    trainer = Trainer(config, [[-2.0, 2.0]] * 6, glm, seed=1, enable_tb=False,
                      device=device, epoch_scan=args.mode == "scan")
    logf = open(args.log, "a") if args.log else None
    records = []

    def record(rec):
        records.append(rec)
        if logf:
            logf.write(json.dumps(rec) + "\n")
            logf.flush()

    record({"event": "start", "mode": args.mode, "batch": args.batch_size,
            "img_shape": list(img_shape), "device": str(device)})
    baseline, recent, slow_streak, aborted = None, [], 0, False
    try:
        for epoch in range(args.epochs):
            loader.set_epoch(trainer.epoch)
            t0 = time.perf_counter()
            if args.mode == "scan":
                losses, fbs, _ = trainer._train_epoch_replayed(loader)
            else:
                losses, fbs, _ = trainer._run_steps(loader.iter_index_batches(),
                                                    loader.gather)
            t1 = time.perf_counter()
            ep_loss = float(losses.sum())
            t2 = time.perf_counter()
            trainer._account_mvn_fallbacks(fbs)
            trainer.epoch += 1
            rec = {"epoch": epoch, "s": t2 - t0, "return_s": t1 - t0, "sync_s": t2 - t1,
                   "loss": ep_loss / loader.num_samples,
                   "replays": sum(trainer.replays.values()),
                   "captures": sum(trainer.captures.values())}
            if epoch % args.probe_every == 0 or epoch < 3:
                sel = next(iter(loader.iter_index_batches()))
                ts = []
                for _ in range(2):
                    sync(device)
                    t0 = time.perf_counter()
                    float(trainer.train_step(*loader.gather(sel))[0])
                    ts.append(time.perf_counter() - t0)
                rec["probe_step_s"] = min(ts)
                rec.update(_memory(device))
            record(rec)
            if 5 <= epoch < 20:
                recent.append(rec["s"])
            elif epoch == 20:
                baseline = statistics.median(recent)
                record({"event": "baseline", "s_per_epoch": baseline})
            if baseline is not None:
                slow_streak = slow_streak + 1 if rec["s"] > args.abort_factor * baseline else 0
                if slow_streak >= 5:
                    record({"event": "aborted_degraded", "epoch": epoch,
                            "baseline_s": baseline, "last_s": rec["s"]})
                    aborted = True
                    break
    finally:
        if logf:
            logf.close()
    epochs = [r for r in records if "epoch" in r and "s" in r]
    return emit({"tool": "epoch_scan_diagnosis", "mode": args.mode, "device": str(device),
                 "batch": args.batch_size, "img_shape": list(img_shape),
                 "epochs_run": len(epochs), "aborted": aborted, "baseline_s": baseline,
                 "captures": dict(trainer.captures), "replays": dict(trainer.replays),
                 "records": records})


if __name__ == "__main__":
    main()
