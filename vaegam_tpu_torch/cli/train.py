"""Training orchestrator CLI of the port.

Flag-for-flag the parser of ``vaegam_tpu.cli.train`` (reference
multsubj_reg_run_GP.py:21-54, hyphenated ``--batch-size`` included), plus
``--device`` (default: the CUDA device; ``cpu`` runs the port on the CPU).
``main`` follows the JAX CLI: the on-card data cache
(``VAEGAM_CACHE_MAX_BYTES`` shrinks its budget), the streaming loader when
the data exceeds it, the GLM maps and inducing-point ranges from the CSVs,
the Trainer with TensorBoard, ``--from_ckpt`` resume, ``train_loop``, then
the output stage (latent plot, GP plots, per-volume reconstructions,
averaged maps; ``--no_outputs`` skips it, ``--recons_only`` runs it alone
from a checkpoint, ``--eval_batch_size`` widens its batches), and an
optional torch.profiler trace.

Not ported yet, and refused before any work when set away from their
defaults: data parallelism, ``--epoch_scan``, ``--qu_s_cholesky``,
``--x64_epsilon`` and ``--stream_dtype``.

    python -m vaegam_tpu_torch.cli.train --train_csv T --test_csv E \\
        --glm_maps G --save_dir S --epochs N --batch-size 32
"""

from __future__ import annotations

import argparse
import os
import time

import pandas as pd
import torch

from .._device import resolve_device
from ..data import setup_data_loaders, setup_device_loaders, wide_eval_view
from ..data.device_cache import DEFAULT_MAX_BYTES
from ..models import VAEGAMConfig
from ..outputs import mk_avg_maps, mk_single_volumes, plot_GPs, project_latent
from ..train import Trainer
from ..utils.stats import get_xu_ranges, str2bool

# flags whose non-default values wait for a later module of the port
_NOT_YET = (
    ("data_parallel", False, "data parallel, ROADMAP module item 10"),
    ("multihost", False, "data parallel, ROADMAP module item 10"),
    ("epoch_scan", False, "whole-epoch replay, ROADMAP module item 6"),
    ("qu_s_cholesky", False, "opt-in paths of ROADMAP module item 1"),
    ("x64_epsilon", False, "opt-in paths of ROADMAP module item 1"),
    ("stream_dtype", "float32", "prefetch loader, ROADMAP module item 5"),
)


def build_parser():
    parser = argparse.ArgumentParser(description="user args for vae_gam model")
    parser.add_argument("--train_csv", type=str, metavar="N", default="",
                        help="Full path to csv file with train dset to be used by DataClass and loaders. This is created by the pre_proc script.")
    parser.add_argument("--test_csv", type=str, metavar="N", default="",
                        help="Full path to csv file with test dset to be used by DataClass and loaders. This is created by the pre_proc script.")
    parser.add_argument("--save_dir", type=str, metavar="N", default="",
                        help="Dir where model params, latent projection maps, GP plots and reconstruction files are saved to. Default is to save files to current dir.")
    parser.add_argument("--batch-size", type=int, default=32, metavar="N",
                        help="Input batch size for training (default: 32)")
    parser.add_argument("--epochs", type=int, default=300, metavar="N",
                        help="Number of epochs to train (default: 300)")
    parser.add_argument("--seed", type=int, default=1, metavar="S",
                        help="Random seed (default: 1)")
    parser.add_argument("--save_freq", type=int, default=100, metavar="N",
                        help="How many epochs to wait before saving training status.")
    parser.add_argument("--test_freq", type=int, default=200, metavar="N",
                        help="How many epochs to wait before testing.")
    parser.add_argument("--split", type=int, metavar="N", default=98,
                        help="Number used to change colors when plotting VAE latent projection. This is # of volumes for each subj -- i.e., color scheme is per subj.")
    parser.add_argument("--glm_reg_scale", type=float, metavar="N", default=1.0,
                        help="Scaling factor for GLM map regularization term (default: 1)")
    parser.add_argument("--glm_maps", type=str, metavar="N", default="",
                        help="Path to csv file containing matrix with approximate GLM maps, one per covariate.")
    parser.add_argument("--num_inducing_pts", type=int, metavar="N", default=6,
                        help="Number of inducing points for each regressor 1D GP.")
    parser.add_argument("--gp_kl_scale", type=float, metavar="N", default=10.0,
                        help="Scaling factor for KL divergence loss terms coming from linear and non-linear (GP) pieces of gamma.")
    parser.add_argument("--from_ckpt", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Boolean flag indicating if training and/or reconstruction should be carried using a pre-trained model state.")
    parser.add_argument("--ckpt_path", type=str, metavar="N", default="",
                        help="Path to ckpt with saved model state to be loaded. Only effective if --from_ckpt == True.")
    parser.add_argument("--recons_only", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Boolean flag indicating if trainig is to be skipped.")
    parser.add_argument("--neural_covariates", type=str2bool, nargs="?",
                        const=True, default=True,
                        help="Boolean flag indicating if covariate set includes neural/biological effects which should be convolved with the HRF.")
    parser.add_argument("--no_outputs", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Skip the post-training output stage (latent plot, GP plots, "
                             "reconstructions, averaged maps). Extension flag; default False "
                             "reproduces the reference pipeline.")
    parser.add_argument("--log_figs_every", type=int, metavar="N", default=50,
                        help="Log per-batch map/beta TB figures every N batches (0 = off). The reference logs these EVERY batch; the default 50 keeps the same TB artifact families as a sampled subset.")
    parser.add_argument("--data_parallel", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Shard batches over all visible devices (not ported yet).")
    parser.add_argument("--nf", type=int, metavar="N", default=8,
                        help="Conv feature multiplier (reference default 8; exposed for small-scale runs).")
    parser.add_argument("--num_latents", type=int, metavar="N", default=32,
                        help="VAE latent dimension (reference default 32).")
    parser.add_argument("--profile_dir", type=str, metavar="N", default="",
                        help="If set, write a torch.profiler trace of training (trace.json) into this directory.")
    parser.add_argument("--img_shape", type=int, metavar="N", nargs=3,
                        default=[41, 49, 35],
                        help="Volume grid (x y z). Default is the reference's 41 49 35; e.g. 91 109 91 for MNI-grid volumes.")
    parser.add_argument("--multihost", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Multi-host training (not ported yet).")
    parser.add_argument("--qu_s_cholesky", type=str2bool, nargs="?",
                        const=True, default=False,
                        help="Parameterize each GP posterior covariance as L L^T (not ported yet).")
    parser.add_argument("--skip_nonfinite_updates", type=str2bool, nargs="?",
                        const=True, default=True,
                        help="Skip optimizer updates whose gradients contain inf/NaN (the regime where the reference crashes); healthy-step numerics unchanged.")
    parser.add_argument("--grad_clip", type=float, metavar="N", default=0.0,
                        help="Global-norm gradient clipping (0 = off).")
    parser.add_argument("--device_data_cache", type=str2bool, nargs="?",
                        const=True, default=True,
                        help="Upload the whole dataset to device memory once and gather batches on device (falls back to the streaming loader for datasets over 4 GiB).")
    parser.add_argument("--cache_dtype",
                        choices=["auto", "float32", "bfloat16", "float16"],
                        default="auto",
                        help="Device-cache precision. auto (default): float32 when it fits the budget, else float16 (float32 restored in the gather).")
    parser.add_argument("--stream_dtype",
                        choices=["float32", "bfloat16", "float16"],
                        default="float32",
                        help="Host->device wire precision of the prefetch loader (not ported yet; float32 only).")
    parser.add_argument("--recon_wire_dtype",
                        choices=["float32", "float16"], default="float32",
                        help="Device->host wire precision for the recon output stage's 10 maps. float16 halves the copied bytes at 2^-11 RELATIVE quantization; the written .nii files stay float32. Default float32 = bit-exact parity.")
    parser.add_argument("--eval_batch_size", type=int, metavar="N", default=0,
                        help="Batch width for the post-training output stage (latent projection + volume reconstruction). 0 (default) reuses --batch-size (batch-stat norms make outputs batch-size-dependent). N>0 widens the eval forwards; capped so two 10-map output blocks fit in 1.5 GiB.")
    parser.add_argument("--x64_epsilon", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Float64 epsilon like the reference (not ported yet).")
    parser.add_argument("--epoch_scan", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="One dispatch per epoch segment (not ported yet).")
    parser.add_argument("--conv_dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Conv-stack activation/compute precision. float32 (default) is the reference-parity path; bfloat16 runs the conv stacks in bf16 with fp32 norm statistics, FC layers and sigmoid.")
    parser.add_argument("--fused_norm_stats", type=str2bool, nargs="?",
                        const=True, default=False,
                        help="Joint decoder batch-norm statistics over the fused 9B decode instead of the reference's per-one-hot statistics. Default off (reference parity).")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device to run on (default: the CUDA device; 'cpu' runs the port on the CPU).")
    return parser


def check_ported(args) -> None:
    """Refuse, before any work, what this port cannot run yet."""
    for name, default, where in _NOT_YET:
        if getattr(args, name) != default:
            raise NotImplementedError(f"--{name} {getattr(args, name)} is not "
                                      f"ported yet ({where})")


def main(argv=None):
    """Run the CLI; returns (trainer, loaders) for callers that drive it."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    if args.save_dir == "":
        args.save_dir = os.getcwd()
    os.makedirs(args.save_dir, exist_ok=True)
    main_start = time.time()

    loader_kwargs = dict(batch_size=args.batch_size, train_csv=args.train_csv,
                         test_csv=args.test_csv, seed=args.seed)
    loaders_dict = None
    if args.device_data_cache:
        # test/ops hook: shrink the device cache budget to force the
        # streaming fallback (or the auto float16 cache)
        max_bytes = int(os.environ.get("VAEGAM_CACHE_MAX_BYTES", DEFAULT_MAX_BYTES))
        try:
            loaders_dict = setup_device_loaders(max_bytes=max_bytes,
                                                cache_dtype=args.cache_dtype,
                                                device=device, **loader_kwargs)
        except ValueError as e:
            print(f"[device cache disabled] {e} — using the streaming "
                  "DataLoader (the prefetch loader is not ported yet, ROADMAP "
                  "module item 5)")
    if loaders_dict is None:
        loaders_dict = setup_data_loaders(**loader_kwargs)
    else:
        sec = loaders_dict["Shuffled_train"].build_seconds
        print(f"[device cache] {loaders_dict['Shuffled_train'].num_samples} "
              f"volumes decoded in {sec['decode']:.2f} s, uploaded in "
              f"{sec['upload']:.2f} s")

    config = VAEGAMConfig(
        nf=args.nf,
        num_latents=args.num_latents,
        img_shape=tuple(args.img_shape),
        num_inducing_pts=args.num_inducing_pts,
        gp_kl_scale=args.gp_kl_scale,
        glm_reg_scale=args.glm_reg_scale,
        neural_covariates=args.neural_covariates,
        conv_dtype=(torch.bfloat16 if args.conv_dtype == "bfloat16" else None),
        fused_norm_stats=args.fused_norm_stats,
    )
    glm_maps = None
    if args.glm_maps:
        glm_maps = pd.read_csv(args.glm_maps).to_numpy()
    xu_ranges = get_xu_ranges([args.train_csv, args.test_csv])

    trainer = Trainer(
        config, xu_ranges, glm_maps=glm_maps, save_dir=args.save_dir,
        seed=args.seed, log_figs_every=args.log_figs_every,
        skip_nonfinite_updates=args.skip_nonfinite_updates,
        grad_clip=args.grad_clip, recon_wire_dtype=args.recon_wire_dtype,
        device=device,
    )

    if args.from_ckpt:
        if not os.path.exists(args.ckpt_path):
            raise FileNotFoundError("Oops, looks like ckpt file given does NOT exist!")
        print("=" * 40)
        print(f"Loading model state from: {args.ckpt_path}")
        trainer.load_state(args.ckpt_path)

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    if not args.recons_only:
        trainer.train_loop(
            loaders_dict, epochs=args.epochs, test_freq=args.test_freq,
            save_freq=args.save_freq, save_dir=args.save_dir,
        )
    elif not args.from_ckpt:
        raise ValueError("To choose recons_only option, --from_ckpt needs to be TRUE.")
    if not args.no_outputs:
        # the output stage at the training width unless --eval_batch_size:
        # the batch-stat norms make every forward batch-size-dependent
        eval_loaders = dict(loaders_dict)
        if args.eval_batch_size:
            eval_loaders["UnShuffled_train"] = wide_eval_view(
                loaders_dict["UnShuffled_train"], config.img_dim,
                width=args.eval_batch_size,
            )
        project_latent(trainer, eval_loaders, title="Latent Space plot",
                       split=args.split, save_dir=args.save_dir)
        plot_GPs(trainer, csv_file=args.train_csv, save_dir=args.save_dir)
        mk_single_volumes(eval_loaders["UnShuffled_train"], trainer,
                          args.train_csv, args.save_dir)
        mk_avg_maps(args.train_csv, trainer, args.save_dir, mk_motion_maps=True)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    print(f"Total model runtime (seconds): {time.time() - main_start}")
    return trainer, loaders_dict


if __name__ == "__main__":
    main()
