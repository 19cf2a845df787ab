"""Convert a reference (PyTorch VAE-GAM) checkpoint into the JAX checkpoint format.

    python -m vaegam_tpu_torch.cli.import_torch_ckpt \\
        --torch_ckpt RUN/checkpoint_100.tar --out_ckpt NEW/checkpoint_100.tar

The port's copy of ``vaegam_tpu.cli.import_torch_ckpt`` (same flags, same
file): reads the ``.tar`` the reference's ``save_state`` writes
(vae_reg_GP.py:452-471), carries every layer, the epsilon map (float32) and
the GP bank (its raw ``qu_S``) into the JAX layout with ``utils.torch_port``,
and writes a checkpoint that ``--from_ckpt --ckpt_path`` of either package's
train CLI accepts.  Adam starts afresh (count 0, zero moments): torch's and
optax's moments are not interchangeable, so a resumed run restarts them and
inference is unaffected.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.vaegam import hrf_kernel
from ..train.checkpoint import save_checkpoint
from ..utils.torch_port import DEC_LAYERS, ENC_LAYERS, port_gp_params, port_layer_state
from ..utils.tree import tree_map


def build_parser():
    parser = argparse.ArgumentParser(
        description="convert a reference torch checkpoint to vaegam_tpu format"
    )
    parser.add_argument("--torch_ckpt", type=str, required=True,
                        help="Path to the reference checkpoint_*.tar")
    parser.add_argument("--out_ckpt", type=str, required=True,
                        help="Output path for the converted checkpoint")
    parser.add_argument("--nf", type=int, default=8,
                        help="Conv feature multiplier of the saved model (default 8)")
    return parser


def _host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def convert(torch_ckpt: str, out_ckpt: str, nf: int = 8) -> None:
    state = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
    params = port_layer_state({n: _host(state[n]) for n in ENC_LAYERS + DEC_LAYERS}, nf)
    params["epsilon"] = np.asarray(_host(state["epsilon"]), np.float32)
    params["gp"], xu = port_gp_params(_host(state["gp_params"]))
    num_latents = int(state["z_dim"]) - 9  # z_dim = latents + covariates + 1
    if params["enc"]["fc41"]["w"].shape[1] != num_latents:
        raise ValueError(f"z_dim {state['z_dim']} does not fit the encoder's heads "
                         f"({params['enc']['fc41']['w'].shape[1]} latents)")
    # optax.adam(lr).init(params): a step count and zero moments, in the
    # positional layout of (ScaleByAdamState(count, mu, nu), EmptyState())
    opt_state = ((np.zeros((), np.int32), tree_map(np.zeros_like, params),
                  tree_map(np.zeros_like, params)), ())
    lr = float(state.get("lr", 1e-3))
    save_checkpoint(
        out_ckpt, params, opt_state,
        epoch=int(state["epoch"]),
        loss=state.get("loss", {"train": {}, "test": {}}),
        z_dim=int(state["z_dim"]),
        lr=lr,
        save_dir=os.path.dirname(os.path.abspath(out_ckpt)),
        glm_reg_scale=float(state["glm_reg_scale"]),
        gp_kl_scale=float(state["gp_kl_scale"]),
        inducing_pts=int(state["inducing_pts"]),
        consts={"xu": xu, "hrf": hrf_kernel().numpy(), "glm_maps": None},
    )
    print(out_ckpt)


def main(argv=None):
    args = build_parser().parse_args(argv)
    convert(args.torch_ckpt, args.out_ckpt, args.nf)


if __name__ == "__main__":
    main()
