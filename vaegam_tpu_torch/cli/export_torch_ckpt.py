"""Convert a checkpoint of either package into the reference's torch format.

    python -m vaegam_tpu_torch.cli.export_torch_ckpt \\
        --ckpt RUN/checkpoint_100.tar --out_ckpt REF_RUN/checkpoint_100.tar

The port's copy of ``vaegam_tpu.cli.export_torch_ckpt`` (same flags, same
file): a ``torch.save`` .tar that the reference's ``VAE.load_state``
(vae_reg_GP.py:473-539) accepts, loadable with ``weights_only=True``:
per-layer state dicts, epsilon as a float64 ``nn.Parameter``, the
per-covariate gp_params (``nn.Parameter``s, ``xu`` a plain tensor; a
Cholesky bank as its dense ``qu_S``), the bookkeeping scalars as plain
Python numbers, and a fresh ``torch.optim.Adam`` state over the same
parameter count (the moments restart, as on import).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..train.checkpoint import load_checkpoint
from ..utils.torch_port import export_gp_params, export_layer_state


def build_parser():
    parser = argparse.ArgumentParser(
        description="convert a vaegam_tpu checkpoint to the reference's "
                    "torch format"
    )
    parser.add_argument("--ckpt", type=str, required=True,
                        help="Path to the vaegam_tpu checkpoint_*.tar")
    parser.add_argument("--out_ckpt", type=str, required=True,
                        help="Output path for the torch checkpoint")
    return parser


def _tensor(a) -> torch.Tensor:
    # .copy(): contiguous and writable, and 0-d arrays stay 0-d (the
    # reference's logkvar / log_ls are scalars)
    return torch.from_numpy(np.asarray(a).copy())


def convert(ckpt: str, out_ckpt: str) -> None:
    state = load_checkpoint(ckpt)
    params = state["params"]
    if state.get("consts") is None or "xu" not in state["consts"]:
        raise ValueError(
            f"{ckpt} carries no consts['xu'] (inducing-point locations); "
            "only checkpoints written by this framework's Trainer are "
            "exportable"
        )
    nf = int(np.asarray(params["enc"]["conv1"]["w"]).shape[-1])
    layers = export_layer_state(params, nf)
    out = {name: {k: _tensor(v) for k, v in sd.items()} for name, sd in layers.items()}
    # the reference keeps epsilon as a float64 nn.Parameter (vae_reg_GP.py:54-56)
    out["epsilon"] = torch.nn.Parameter(_tensor(params["epsilon"]).double())
    out["gp_params"] = {
        cov: {k: (_tensor(v) if k == "xu" else torch.nn.Parameter(_tensor(v)))
              for k, v in d.items()}
        for cov, d in export_gp_params(params["gp"], state["consts"]["xu"]).items()
    }
    # plain Python numbers: the reference loads with torch.load's default
    # weights_only=True, which refuses numpy scalars
    out["loss"] = {split: {int(k): float(v) for k, v in d.items()}
                   for split, d in state.get("loss", {"train": {}, "test": {}}).items()}
    out["z_dim"] = int(state["z_dim"])
    out["epoch"] = int(state["epoch"])
    out["lr"] = float(state.get("lr", 1e-3))
    out["save_dir"] = os.path.dirname(os.path.abspath(out_ckpt))
    out["glm_reg_scale"] = float(state["glm_reg_scale"])
    out["gp_kl_scale"] = float(state["gp_kl_scale"])
    out["inducing_pts"] = int(state["inducing_pts"])
    # a fresh Adam over the reference's parameter count, so its
    # optimizer.load_state_dict (vae_reg_GP.py:480) accepts it: every layer
    # tensor, epsilon and every gp nn.Parameter (xu is a plain buffer there)
    n_params = (sum(len(sd) for sd in layers.values()) + 1
                + sum(1 for d in out["gp_params"].values() for k in d if k != "xu"))
    dummies = [torch.nn.Parameter(torch.zeros(1)) for _ in range(n_params)]
    out["optimizer_state"] = torch.optim.Adam(dummies, lr=out["lr"]).state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(out_ckpt)), exist_ok=True)
    torch.save(out, out_ckpt)
    print(out_ckpt)


def main(argv=None):
    args = build_parser().parse_args(argv)
    convert(args.ckpt, args.out_ckpt)


if __name__ == "__main__":
    main()
