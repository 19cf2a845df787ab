"""End-to-end synthetic-control validation: the port's correctness oracle.

The port's own copy of ``vaegam_tpu.tools.control_experiment`` (reference
de-facto oracle, SURVEY.md §4): inject a known synthetic signal into fMRI
volumes, train, and check that the recovered ``task`` covariate map
concentrates on the injected voxels.  It runs the real pipeline: subject
tree -> add_signal CLI -> preproc CLI -> Trainer on the device ->
per-volume reconstruction -> averaged maps -> the recovery check.

Every flag and default of the JAX tool, plus ``--device`` (default: the
CUDA device; ``cpu`` runs on the CPU).  ``--epoch_scan`` trains with the
Trainer's ``epoch_scan`` (CUDA-graph replays of the gather-fused step on
the card; the same eager steps on the CPU).  The initial weights are the
JAX tool's for the same seed.

    python -m vaegam_tpu_torch.tools.control_experiment --work_dir /tmp/ctl \\
        --epochs 900

Prints a JSON line with the recovery metrics (the JAX tool's keys, plus
``stage_seconds``) and exits nonzero when the map was not recovered (or
more steps were skipped than ``--max_skips``), unless ``--no_gate``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import pandas as pd
import torch

from .._device import resolve_device
from ..utils.stats import mk_spherical_mask

MOTION_COLS = ["trans_x", "trans_y", "trans_z", "rot_x", "rot_y", "rot_z"]
# the injected intensity over this is the task map's expected value: the
# data loader's global scale (data/dataset.py GLOBAL_SCALE)
SIGNAL_SCALE = 3284.5


def _scale_coords(coords, img_shape, ref=(41, 49, 35)):
    f = [s / r for s, r in zip(img_shape, ref)]
    return [tuple(int(round(c * fi)) for c, fi in zip(co, f))
            for co in coords]


def build_motion_maps(img_shape=(41, 49, 35)):
    """Six disjoint octahedral ground-truth maps, one per motion covariate.

    Anchor corners scale proportionally on non-reference grids."""
    ball = mk_spherical_mask(size=7, radius=1)
    coords = _scale_coords([(5, 6, 5), (30, 8, 8), (8, 36, 8),
                            (30, 36, 10), (8, 8, 25), (28, 36, 24)],
                           img_shape)
    maps = np.zeros((6,) + tuple(img_shape), np.float32)
    for c, (x, y, z) in enumerate(coords):
        maps[c, x:x + 7, y:y + 7, z:z + 7] += ball
    return maps


def build_sex_map(img_shape=(41, 49, 35)):
    """Octahedral ground-truth map for the (binary, un-z-scored) sex cov."""
    ball = mk_spherical_mask(size=7, radius=1)
    maps = np.zeros(tuple(img_shape), np.float32)
    (x, y, z), = _scale_coords([(16, 20, 22)], img_shape)
    maps[x:x + 7, y:y + 7, z:z + 7] += ball
    return maps


def build_fake_subjects(root, n_subjs, n_vols, seed=0,
                        motion_artifact_intensity=0.0,
                        sex_effect_intensity=0.0,
                        noise_sigma=15.0,
                        anatomy_var=1.0,
                        img_shape=(41, 49, 35)):
    """Smooth random 'anatomy' + noise per subject, as 4D NIfTI files with
    fmriprep-style motion TSVs and a sex CSV (the JAX tool's bytes).

    motion_artifact_intensity > 0 adds sum_c z_c(t) * intensity * M_c with
    the known octahedral maps M_c (z_c the population-z-scored covariate
    the model sees) and returns the (6, *img_shape) maps, else None.
    anatomy_var in [0, 1] mixes a shared template field with per-subject
    fields: field_s = (1-v)*template + v*independent_s.
    """
    from scipy import ndimage

    from ..utils import nifti

    rng = np.random.default_rng(seed)

    # smoothing length scales with the grid so "anatomy" has the same
    # relative feature size on every volume geometry
    sig_vox = 4.0 * (sum(img_shape) / (41 + 49 + 35))

    def smooth_field(r):
        f = ndimage.gaussian_filter(r.normal(size=img_shape), sigma=sig_vox)
        return (f - f.min()) / (f.max() - f.min())

    # template from its own stream, so the main stream is the same for
    # every anatomy_var
    template = smooth_field(np.random.default_rng(seed + 10_000))
    subj_ids, vols_all, mot_all = [], [], []
    for s in range(n_subjs):
        subj = f"sub-A000{70 + s:02d}"
        subj_ids.append(subj)
        os.makedirs(os.path.join(root, subj), exist_ok=True)
        # smooth random field = representable "anatomy" (white noise is not
        # expressible by a conv decoder and would bury the injected signal)
        field = ((1.0 - anatomy_var) * template
                 + anatomy_var * smooth_field(rng))
        base = (300 + 2500 * field).astype(np.float32)
        vols = np.stack(
            [base + rng.normal(0, noise_sigma, img_shape)
             for _ in range(n_vols)],
            axis=-1,
        ).astype(np.float32)
        if sex_effect_intensity > 0 and s % 2 == 1:
            # subjects with sex=1 carry a constant effect at a known map
            vols += (sex_effect_intensity
                     * build_sex_map(img_shape))[..., None]
        mot = pd.DataFrame(
            {c: rng.normal(0, 0.4, n_vols) for c in MOTION_COLS}
        )
        vols_all.append(vols)
        mot_all.append(mot)

    motion_maps = None
    if motion_artifact_intensity > 0:
        motion_maps = build_motion_maps(img_shape)
        # population z-score over ALL subjects' rows (ddof=0): the injected
        # effect is per unit of the covariate the model receives
        allmot = pd.concat(mot_all, ignore_index=True)
        mean, std = allmot.mean(axis=0), allmot.std(axis=0, ddof=0)
        for s in range(n_subjs):
            z = ((mot_all[s] - mean) / std).to_numpy()  # (n_vols, 6)
            art = np.einsum(
                "tc,cxyz->xyzt", z.astype(np.float32),
                motion_artifact_intensity * motion_maps,
            )
            vols_all[s] += art

    for s, subj in enumerate(subj_ids):
        sdir = os.path.join(root, subj)
        nifti.save(
            nifti.Nifti1Image(vols_all[s], np.diag([3.0, 3.0, 3.0, 1.0])),
            os.path.join(
                sdir, f"{subj}_preproc_bold_brainmasked_resampled.nii.gz"
            ),
        )
        mot_all[s].to_csv(
            os.path.join(
                sdir,
                f"{subj}_task-CHECKERBOARD_acq-1400_desc-confounds_"
                "regressors_toy.tsv",
            ),
            sep="\t", index=False,
        )
    pd.DataFrame(
        {"subjID": subj_ids, "gender ": [i % 2 for i in range(n_subjs)]}
    ).to_csv(os.path.join(root, "sex_info.csv"), index=False)
    return motion_maps


def build_glm_maps(intensity, img_shape, motion_maps=None, motion_artifacts=0.0,
                   sex_effect=0.0):
    """Ground-truth beta maps (img_dim, 9) float32, the CSV's layout read
    with its index column: task = the scaled injected signal, motion = the
    scaled injected artifacts (or 0), sex = the scaled sex effect (or 0)."""
    from ..cli.add_signal import build_control_signal

    sig = build_control_signal(
        "simple", intensity, 1, 7, img_shape=img_shape) / SIGNAL_SCALE
    glm_maps = np.zeros((sig.size, 9), np.float32)
    glm_maps[:, 1] = sig.reshape(-1)
    if motion_maps is not None:
        for c in range(6):
            glm_maps[:, 2 + c] = (
                motion_artifacts * motion_maps[c].reshape(-1) / SIGNAL_SCALE
            )
    if sex_effect > 0:
        glm_maps[:, 8] = (
            sex_effect * build_sex_map(img_shape).reshape(-1) / SIGNAL_SCALE
        )
    return glm_maps


def recovery_metrics(task_map, intensity, img_shape):
    """The recovery check of one averaged task map: the mean |map| inside
    the injected spheres over the mean |map| outside (contrast), and the
    signed inside mean against the expected intensity / SIGNAL_SCALE.
    Recovered when the contrast exceeds 2 and the inside mean a quarter of
    the expected value.  Unrounded."""
    from ..cli.add_signal import build_control_signal

    mask = build_control_signal("simple", 1.0, 1, 7, img_shape=img_shape) > 0
    inside = float(np.mean(np.abs(task_map[mask])))
    outside = float(np.mean(np.abs(task_map[~mask])))
    contrast = inside / max(outside, 1e-12)
    expected = intensity / SIGNAL_SCALE
    inside_mean = float(np.mean(task_map[mask]))
    return {"inside_mean": inside_mean, "expected": expected, "abs_inside": inside,
            "abs_outside": outside, "contrast": contrast,
            "recovered": bool(contrast > 2.0 and inside_mean > 0.25 * expected)}


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--work_dir", type=str, required=True)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--n_vols", type=int, default=98)
    parser.add_argument("--n_subjs", type=int, default=1)
    parser.add_argument("--intensity", type=float, default=1000.0)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--qu_s_cholesky", action="store_true", default=True,
                        help="Use the PSD qu_S parameterization (default on: "
                        "the reference's raw parameterization diverges on "
                        "this toy around epoch ~16, its known instability).")
    parser.add_argument("--no-qu_s_cholesky", dest="qu_s_cholesky",
                        action="store_false")
    parser.add_argument("--glm_reg", action="store_true", default=True,
                        help="Train with the GLM regularizer on ground-truth "
                        "beta maps of the injected signal.  Default on: the "
                        "pass/fail gate; --no-glm_reg (the reference's control "
                        "setup) is weakly identified and seed-sensitive.")
    parser.add_argument("--no-glm_reg", dest="glm_reg", action="store_false")
    parser.add_argument("--bf16_convs", action="store_true", default=False,
                        help="Run the conv stacks with bfloat16 activations.")
    parser.add_argument("--half_recipe", type=str, default="",
                        choices=["", "off", "full", "encoder", "decoder",
                                 "fp32_final"],
                        help="Per-stack bf16 recipe: full = both conv stacks "
                        "bf16 (same as --bf16_convs); encoder = bf16 encoder + "
                        "fp32 decoder; decoder = fp32 encoder + bf16 decoder; "
                        "fp32_final = both stacks bf16 except the "
                        "sigmoid-feeding convt5.  Overrides --bf16_convs.")
    parser.add_argument("--bf16_warmstart", type=int, default=0,
                        help="Train the first N epochs with fp32 convs, then "
                        "switch to bfloat16 for the rest.")
    parser.add_argument("--fused_norm_stats", action="store_true",
                        default=True,
                        help="Joint decoder norm statistics over all 9B "
                        "fused-decode rows instead of the reference's "
                        "per-one-hot stats (default on for the oracle: more "
                        "stable on this toy, docs/CONTROL_EXPERIMENT.md).")
    parser.add_argument("--reference_norm_stats", dest="fused_norm_stats",
                        action="store_false",
                        help="Use the reference's per-one-hot decoder norm "
                        "statistics (the 1e-3-parity semantics).")
    parser.add_argument("--glm_reg_scale", type=float, default=None,
                        help="Weight of the GLM regularizer term.  Default: "
                        "1 (the reference default) for single-subject, 10 "
                        "for multi-subject.")
    parser.add_argument("--sex_effect", type=float, default=None,
                        help="Constant anatomical effect at a known "
                        "octahedral map in sex=1 subjects.  Default: 200 for "
                        "n_subjs >= 10, 0 otherwise.")
    parser.add_argument("--anatomy_var", type=float, default=None,
                        help="Inter-subject anatomy variation in [0,1]. "
                        "Default: 0.3 for n_subjs >= 10, 1.0 otherwise.")
    parser.add_argument("--noise_sigma", type=float, default=15.0,
                        help="Per-volume Gaussian noise sigma (raw intensity "
                        "units; anatomy spans 300-2800).")
    parser.add_argument("--max_skips", type=int, default=-1,
                        help="If >= 0, the run FAILS when more than this many "
                        "optimizer steps were skipped non-finite, even if the "
                        "map recovered; default -1 = report only.")
    parser.add_argument("--no_gate", action="store_true", default=False,
                        help="Report metrics but always exit 0.")
    parser.add_argument("--reuse_data", action="store_true", default=False,
                        help="Skip subject generation + signal injection + "
                        "preproc when work_dir already holds the CSV from a "
                        "previous run with the SAME data knobs.")
    parser.add_argument("--run_name", type=str, default="run",
                        help="Subdirectory of work_dir for this run's "
                        "outputs (checkpoints, recons).")
    parser.add_argument("--img_shape", type=int, nargs=3,
                        default=[41, 49, 35],
                        help="Volume grid (D H W); signal/artifact placements "
                        "scale proportionally.  Default: the reference grid.")
    parser.add_argument("--cache_dtype", type=str, default="auto",
                        help="Device-cache dtype (auto/float32/bfloat16/"
                        "float16).")
    parser.add_argument("--epoch_scan", action="store_true", default=False,
                        help="Fuse each epoch's uniform-size steps into one "
                             "lax.scan dispatch (Trainer epoch_scan knob; "
                             "recipe study arm — see docs/PERFORMANCE.md).")
    parser.add_argument("--motion_artifacts", type=float, default=None,
                        help="Inject motion-correlated artifacts with known "
                        "octahedral maps at this intensity.  Default: 150 for "
                        "multi-subject runs, 0 for single-subject.")
    parser.add_argument("--tpu_products", action="store_true", default=False,
                        help="Compute every product of the step in the TPU's "
                        "arithmetic, the one the JAX package's records were "
                        "made in: both operands rounded to bfloat16, float32 "
                        "sums (VAEGAMConfig.tpu_products).")
    parser.add_argument("--no-tpu_products", dest="tpu_products",
                        action="store_false")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device to run on (default: the CUDA device; "
                        "'cpu' runs the port on the CPU).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from ..cli import add_signal, preproc
    from ..data import setup_device_loaders
    from ..models import VAEGAMConfig
    from ..outputs import mk_avg_maps, mk_single_volumes
    from ..train import Trainer
    from ..utils import nifti
    from ..utils.stats import get_xu_ranges

    img_shape = tuple(args.img_shape)
    data_dir = os.path.join(args.work_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    if args.motion_artifacts is None:
        args.motion_artifacts = 150.0 if args.n_subjs > 1 else 0.0
    if args.glm_reg_scale is None:
        args.glm_reg_scale = 10.0 if args.n_subjs > 1 else 1.0
    if args.sex_effect is None:
        args.sex_effect = 200.0 if args.n_subjs >= 10 else 0.0
    if args.anatomy_var is None:
        args.anatomy_var = 0.3 if args.n_subjs >= 10 else 1.0
    stages = {}
    # newest by mtime: the %m_%d_%Y date in the filename does not sort
    # chronologically as a string
    existing_csv = sorted(
        glob.glob(os.path.join(args.work_dir, "preproc_dset_zscored_*.csv")),
        key=os.path.getmtime,
    )
    if args.reuse_data and existing_csv:
        t0 = time.time()
        csv = existing_csv[-1]
        motion_maps = (build_motion_maps(img_shape)
                       if args.motion_artifacts > 0 else None)
        print(f"[reuse_data] using {csv}")
    else:
        t_gen = time.time()
        motion_maps = build_fake_subjects(
            data_dir, args.n_subjs, args.n_vols, seed=0,
            motion_artifact_intensity=args.motion_artifacts,
            sex_effect_intensity=args.sex_effect,
            noise_sigma=args.noise_sigma,
            anatomy_var=args.anatomy_var,
            img_shape=img_shape,
        )
        t0 = time.time()
        stages["generate"] = t0 - t_gen
        add_signal.main(
            ["--root_dir", data_dir, "--intensity", str(args.intensity),
             "--shape", "simple",
             "--img_shape", *[str(i) for i in img_shape]]
        )
        stages["add_signal"] = time.time() - t0
        t1 = time.time()
        csv = preproc.main(
            ["--data_dir", data_dir, "--save_dir", args.work_dir, "--control",
             "--control_int", str(int(args.intensity)), "--set_tag", "TRAIN",
             "--nii_file_pattern", "*_ALTERED_simple_*.nii.gz",
             "--sex_info", os.path.join(data_dir, "sex_info.csv"),
             "--mot_file_pattern",
             "sub-A000*_desc-confounds_regressors_*.tsv"]
        )
        stages["preproc"] = time.time() - t1

    run_dir = os.path.join(args.work_dir, args.run_name)
    glm_maps = None
    glm_reg_scale = 0.0
    if args.glm_reg:
        glm_maps = build_glm_maps(args.intensity, img_shape, motion_maps,
                                  args.motion_artifacts, args.sex_effect)
        glm_reg_scale = args.glm_reg_scale

    warm = min(args.bf16_warmstart, args.epochs) if args.bf16_warmstart else 0
    bf16 = torch.bfloat16
    recipe = args.half_recipe or ("full" if args.bf16_convs else "off")
    if warm and recipe not in ("off", "full"):
        raise SystemExit("--bf16_warmstart only composes with whole-stack "
                         "recipes (set_conv_dtype switches conv_dtype only)")
    stack_kw = {
        "off": dict(conv_dtype=None),
        "full": dict(conv_dtype=None if warm else bf16),
        "encoder": dict(conv_dtype=None,
                        enc_conv_dtype=None if warm else bf16),
        "decoder": dict(conv_dtype=None,
                        dec_conv_dtype=None if warm else bf16),
        "fp32_final": dict(conv_dtype=None if warm else bf16,
                           dec_fp32_final=True),
    }[recipe]
    config = VAEGAMConfig(glm_reg_scale=glm_reg_scale,
                          neural_covariates=False,
                          img_shape=img_shape,
                          qu_s_cholesky=args.qu_s_cholesky,
                          fused_norm_stats=args.fused_norm_stats,
                          tpu_products=args.tpu_products,
                          **stack_kw)
    loaders = setup_device_loaders(batch_size=args.batch_size, train_csv=csv,
                                   test_csv=csv, seed=args.seed,
                                   cache_dtype=args.cache_dtype, device=device)
    trainer = Trainer(config, get_xu_ranges([csv, csv]), glm_maps=glm_maps,
                      save_dir=run_dir, seed=args.seed, enable_tb=False,
                      epoch_scan=args.epoch_scan, device=device)
    t_train0 = time.time()
    if warm:
        trainer.train_loop(loaders, epochs=warm, test_freq=None,
                           save_freq=None, save_dir=run_dir)
        print(f"[bf16_warmstart] switching convs to bfloat16 after "
              f"{warm} fp32 epochs")
        trainer.set_conv_dtype(bf16)
    trainer.train_loop(loaders, epochs=args.epochs - warm, test_freq=None,
                       save_freq=None, save_dir=run_dir)
    train_secs = time.time() - t_train0
    stages["train"] = train_secs
    trainer.save_state(os.path.join(run_dir, "final.tar"))  # for diagnosis

    t1 = time.time()
    mk_single_volumes(loaders["UnShuffled_train"], trainer, csv, run_dir)
    stages["recon"] = time.time() - t1
    t1 = time.time()
    mk_avg_maps(csv, trainer, run_dir,
                mk_motion_maps=args.motion_artifacts > 0)
    stages["averages"] = time.time() - t1

    # --- recovery check ------------------------------------------------------
    ckpt = str(trainer.epoch).zfill(3)
    avg_dir = os.path.join(run_dir, "reconstructions",
                           f"{ckpt}_avg_model_recons")
    task_map = np.array(nifti.load(os.path.join(avg_dir, "task_avg.nii")).dataobj)
    rec = recovery_metrics(task_map, args.intensity, img_shape)
    vols_per_sec = args.epochs * args.n_vols * args.n_subjs / train_secs

    # recovery metrics for the other signal-carrying covariates
    extra = {}
    if args.sex_effect > 0 and args.n_subjs >= 2:
        # sex is constant per subject: use a sex=1 subject's average
        sex_subj = f"sub-A000{70 + 1:02d}"
        sex_map = np.array(nifti.load(
            os.path.join(avg_dir, sex_subj, "sex_avg.nii")).dataobj)
        smask = build_sex_map(img_shape) > 0
        s_in = float(np.mean(sex_map[smask]))
        s_out = float(np.mean(np.abs(sex_map[~smask])))
        extra.update(sex_map_mean_inside=round(s_in, 4),
                     sex_expected=round(args.sex_effect / SIGNAL_SCALE, 4),
                     sex_contrast=round(s_in / max(s_out, 1e-12), 2))
    if args.motion_artifacts > 0:
        # zero-mean covariates cancel in time averages, so measure the
        # mean |per-volume| x-motion contribution of one subject instead
        subj = f"sub-A000{70:02d}"
        subj_dir = os.path.join(run_dir, "reconstructions",
                                f"{ckpt}_model_recons", subj)
        acc = None
        vol_dirs = sorted(os.listdir(subj_dir))
        for vd in vol_dirs:
            vol = np.abs(np.array(nifti.load(
                os.path.join(subj_dir, vd, "recon_x_mot.nii")).dataobj))
            acc = vol if acc is None else acc + vol
        acc /= len(vol_dirs)
        mmask = build_motion_maps(img_shape)[0] > 0
        m_in = float(np.mean(acc[mmask]))
        m_out = float(np.mean(acc[~mmask]))
        extra.update(xmot_absmap_mean_inside=round(m_in, 4),
                     xmot_contrast=round(m_in / max(m_out, 1e-12), 2))
    skips = 0
    if trainer.skip_nonfinite_updates:
        skips = int(trainer.opt_state["total_notfinite"])
    result = {
        "n_subjs": args.n_subjs,
        "img_shape": list(img_shape),
        "batch_size": args.batch_size,
        "cache_dtype": args.cache_dtype,
        "motion_artifacts": args.motion_artifacts,
        "anatomy_var": args.anatomy_var,
        "glm_reg_scale": glm_reg_scale,
        "epochs": args.epochs,
        "conv_dtype": ("float32" if recipe == "off" and not warm
                       else recipe if recipe != "full" else "bfloat16"),
        "half_recipe": recipe,
        "bf16_warmstart": warm,
        "epoch_scan": args.epoch_scan,
        "tpu_products": args.tpu_products,
        "train_seconds": round(train_secs, 1),
        "train_vols_per_sec": round(vols_per_sec, 1),
        "task_map_mean_inside": round(rec["inside_mean"], 4),
        "expected_scaled_signal": round(rec["expected"], 4),
        "abs_inside": round(rec["abs_inside"], 4),
        "abs_outside": round(rec["abs_outside"], 5),
        "contrast_ratio": round(rec["contrast"], 2),
        "nonfinite_skips": skips,
        # escalating-jitter engagements of the gain-covariance Cholesky
        "mvn_fallbacks": trainer.mvn_fallbacks,
        "recovered": rec["recovered"],
        "total_seconds": round(time.time() - t0, 1),
        **extra,
        "device": str(device),
        "stage_seconds": {k: round(v, 3) for k, v in stages.items()},
    }
    # epoch-rate stability: baseline = median of epochs 5..19, degradation
    # = worst later epoch over baseline; a healthy run sits near 1.0
    eps = [trainer.epoch_seconds[k] for k in sorted(trainer.epoch_seconds)]
    if len(eps) >= 25:
        ep_base = float(np.median(eps[5:20]))
        ep_max = float(np.max(eps[5:]))
        result["epoch_s_baseline"] = round(ep_base, 3)
        result["epoch_s_max"] = round(ep_max, 3)
        result["epoch_s_degradation"] = round(ep_max / ep_base, 2)
        # a transient spike and a sustained degradation look alike in a
        # max: the count and the series on disk tell them apart
        result["epoch_s_over2x"] = int(np.sum(np.asarray(eps[5:])
                                              > 2 * ep_base))
        with open(os.path.join(run_dir, "epoch_seconds.json"), "w") as f:
            json.dump([round(e, 3) for e in eps], f)
    if args.max_skips >= 0:
        result["max_skips"] = args.max_skips
        result["skips_ok"] = bool(skips <= args.max_skips)
    print(json.dumps(result))
    if args.no_gate:
        return 0
    if args.max_skips >= 0 and not result["skips_ok"]:
        return 1
    return 0 if result["recovered"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
