"""Full-step A/B of the conv5 kernel: the whole train step with encoder conv5
on the hand-written CUDA kernel (``conv5_kernel=True``) against cuDNN's conv
(``conv5_kernel=False``).

Counterpart of ``vaegam_tpu.tools.pallas_fullstep_study`` (the Pallas conv5
against XLA's conv), re-aimed at the port's kernel.  Each arm is a Trainer
at the reference defaults from the same seed, on the same volumes held on
the device (``--batch`` x ``--iters`` of them), warmed by one untimed
block; then the arms alternate, A/B/A/B, for ``--rounds`` rounds of
``--iters`` steps each, in two modes:

  * ``eager``: ``--iters`` eager train steps, one sync at the end; this
    step is host-bound on the card, so the kernel's share hides in host
    gaps;
  * ``replayed``: one ``epoch_scan`` epoch of ``--iters`` steps (a CUDA
    graph of the gather-fused step, replayed), where the step is
    device-bound and the kernel's share shows.

Both arms draw the same noise from the same seed, so their first steps'
losses agree to fp32 reassociation (printed; later steps part slowly, the
GP solves being ill-conditioned at these inducing grids).  On the CPU the
kernel's plain version stands in and ``replayed`` runs the eager steps.

    python -m vaegam_tpu_torch.tools.conv5_fullstep_study [--batch 32]
        [--iters 20] [--rounds 2]

Prints one JSON line: vols/s of each arm, mode and round, and the ratios.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from .._device import resolve_device
from .common import emit, sync

ARMS = {"kernel": True, "cudnn": False}


def _arms(config_kw, batch, iters, device):
    from ..data import DeviceResidentLoader
    from ..models import VAEGAMConfig
    from ..train import Trainer

    config = VAEGAMConfig(**config_kw)
    rng = np.random.default_rng(0)
    n = batch * iters
    vols = rng.uniform(0, 1, size=(n,) + config.img_shape).astype(np.float32)
    covs = rng.normal(size=(n, config.num_covariates)).astype(np.float32)
    glm = rng.normal(size=(config.img_dim, config.num_covariates + 1)).astype(np.float32)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=batch, shuffle=True,
                                              seed=1, device=device)
    out = {}
    for mode in ("eager", "replayed"):
        for arm, on in ARMS.items():
            t = Trainer(dataclasses.replace(config, conv5_kernel=on), [[-2.0, 2.0]] * 6,
                        glm, seed=1, enable_tb=False, device=device,
                        epoch_scan=mode == "replayed")
            out[mode, arm] = t
    return loader, out


def _block(trainer, loader, mode, iters):
    """(seconds, the first step's loss or None, the block's mean loss) of
    one timed block."""
    sync(trainer.device)
    t0 = time.perf_counter()
    first = None
    if mode == "eager":
        loader.set_epoch(0)  # the same batches in every eager block of both arms
        sels = list(loader.iter_index_batches())
        losses = [trainer.train_step(*loader.gather(sels[i % len(sels)]))[0]
                  for i in range(iters)]
        first, loss = float(losses[0]), float(sum(losses)) / iters
    else:
        loss = trainer.train_epoch(loader) * loader.num_samples / iters
    sync(trainer.device)
    return time.perf_counter() - t0, first, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2,
                    help="A/B interleave rounds (kernel, cudnn in each)")
    ap.add_argument("--nf", type=int, default=8)
    ap.add_argument("--num_latents", type=int, default=32)
    ap.add_argument("--img_shape", type=int, nargs=3, default=[41, 49, 35])
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    config_kw = dict(nf=args.nf, num_latents=args.num_latents,
                     img_shape=tuple(args.img_shape))
    loader, trainers = _arms(config_kw, args.batch, args.iters, device)

    vps = {f"{mode}_{arm}": [] for mode, arm in trainers}
    first, losses = {}, {}
    for (mode, arm), t in trainers.items():  # warm-up: searches, captures
        _, loss, _ = _block(t, loader, mode, args.iters)
        if loss is not None:
            first[arm] = loss
    for _ in range(args.rounds):
        for (mode, arm), t in trainers.items():
            sec, _, loss = _block(t, loader, mode, args.iters)
            vps[f"{mode}_{arm}"].append(args.batch * args.iters / sec)
            losses[f"{mode}_{arm}"] = loss
    # the first step's loss: the same weights, batch and noise in both arms
    out = {"tool": "conv5_fullstep_study", "batch": args.batch, "iters": args.iters,
           "rounds": args.rounds, "device": str(device), "vols_per_s": vps,
           "first_step_loss": first, "mean_loss_last_block": losses}
    for mode in ("eager", "replayed"):
        k, c = (np.mean(vps[f"{mode}_{a}"]) for a in ARMS)
        out[f"{mode}_kernel_over_cudnn"] = float(k / c)
        out[f"{mode}_step_ms_delta"] = float(1e3 * args.batch * (1 / k - 1 / c))
    out["captures"] = {arm: dict(trainers["replayed", arm].captures) for arm in ARMS}
    out["replays"] = {arm: dict(trainers["replayed", arm].replays) for arm in ARMS}
    return emit(out)


if __name__ == "__main__":
    main()
