"""The fp32-vs-float64 epsilon precision policy, measured.

Counterpart of ``vaegam_tpu.tools.epsilon_precision_study``.  The reference
trains its per-voxel log-precision map epsilon in float64
(vae_reg_GP.py:54) and casts it to float32 for the log-likelihood
(:402); the port keeps it float32 unless ``VAEGAMConfig.x64_epsilon``.
epsilon enters none of the 10 output maps, so the map criterion does not
depend on its precision; what remains is training drift.  This tool runs
``--steps`` Adam steps of the toy model (nf=2, 8 latents, 21x25x21) with
``x64_epsilon`` off and on, from the same weights, on the same batch and
the same noise, and prints the loss-trajectory and epsilon-map deltas.

    python -m vaegam_tpu_torch.tools.epsilon_precision_study [--steps 20]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from .common import emit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..models import VAEGAMConfig
    from ..models.vaegam import draw_noise
    from ..train import Trainer

    config = VAEGAMConfig(nf=2, num_latents=8, img_shape=(21, 25, 21))
    rng = np.random.default_rng(0)
    covs = torch.tensor(rng.normal(size=(args.batch, 8)), dtype=torch.float32, device=device)
    x = torch.tensor(rng.uniform(0, 1, size=(args.batch,) + config.img_shape),
                     dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    noise = [draw_noise(gen, args.batch, config, device) for _ in range(args.steps)]

    results = {}
    for x64 in (False, True):
        t = Trainer(dataclasses.replace(config, x64_epsilon=x64), [[-2.0, 2.0]] * 6, None,
                    seed=0, enable_tb=False, device=device)
        losses = [float(t.train_step(covs, x, noise=nz)[0]) for nz in noise]
        results["float64" if x64 else "float32"] = {
            "losses": np.array(losses),
            "epsilon": t.params["epsilon"].detach().double().cpu().numpy(),
            "dtype": str(t.params["epsilon"].dtype)}

    l32, l64 = results["float32"]["losses"], results["float64"]["losses"]
    e32, e64 = results["float32"]["epsilon"], results["float64"]["epsilon"]
    return emit({
        "tool": "epsilon_precision_study", "device": str(device), "steps": args.steps,
        "epsilon_dtypes": [results[k]["dtype"] for k in ("float32", "float64")],
        "final_loss_fp32": float(l32[-1]), "final_loss_fp64": float(l64[-1]),
        "max_rel_loss_delta": float(np.max(np.abs(l32 - l64) / np.maximum(np.abs(l64), 1.0))),
        "epsilon_max_abs_delta": float(np.max(np.abs(e32 - e64))),
        "epsilon_rms": float(np.sqrt(np.mean(e64 ** 2))),
    })


if __name__ == "__main__":
    main()
