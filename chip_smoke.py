"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # what the check runs
    python3 chip_smoke.py --profile DIR     # also a torch.profiler breakdown of
                                            # 3 train steps, fp32 and bf16,
                                            # written under DIR

Phases (any failure exits non-zero; nothing is caught to exit 0):
  1. the card: name and power limit (nvidia-smi), TF32 off;
  2. build every CUDA kernel of the main path from this checkout's sources;
  2b. the tensor-core instructions (HMMA) in the built conv5 library;
  3. each kernel against its plain PyTorch version on the card, forward and
     backward, at the main path's shapes and a few others (both of conv5's
     staging paths); device time of conv5 and F.conv3d at the main and MNI
     shapes, with the CUDA-event time of 200 back-to-back calls and the
     host time to enqueue one call beside it;
  4. the train step at the reference's full width: a Trainer at the default
     config (nf=8, 32 latents, 41x49x35, fp32, per-one-hot decoder norm
     statistics, GLM maps on, conv5 kernel on) trains one epoch over 128
     synthetic volumes held on the card (batch 32, 4 steps), then 20 timed
     steps; every loss must be finite and conv5 must have launched once per
     forward.  One deterministic B=4 forward on the card must match the
     same model's CPU forward (plain kernels), on well-conditioned inducing
     grids: tot_loss rtol 1e-4;
  5. the train CLI on a NIfTI study: a 10-subject study at the reference
     grid (98 volumes a subject, 980 in all, one subject .nii.gz, the rest
     .nii) is written with the port's NIfTI codec, with its design and GLM
     maps CSVs; the native decoder is built (make -C native) and both
     decoders are timed on it; then ``vaegam_tpu_torch.cli.train.main``
     runs on the card: fp32, batch 32, 3 epochs, test and save every epoch
     (conv5 must launch once per train and test forward, every loss be
     finite, checkpoint_001/002.tar exist); a fresh Trainer loads
     checkpoint_002.tar to the same params; the CLI resumes from it with
     --from_ckpt for 1 epoch (epoch 3); 1 epoch on the streaming DataLoader
     (a one-byte cache budget); then 2 epochs of the bf16 recipe
     (--conv_dtype bfloat16 --fused_norm_stats), finite losses;
  6. one JSON line with the kernels' numbers, one with the step time, one
     with the CLI's numbers;
  7. as the last line: {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_VOLS, BATCH, TIMED_STEPS = 128, 32, 20
STUDY_SUBJECTS, STUDY_VOLS = 10, 98    # the reference's --split 98
CLI_EPOCHS, BF16_EPOCHS = 3, 2
XU_RANGES = [[-2.0, 2.0]] * 6          # as bench.py
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# TF32 in them, HBM3
FP32_FLOPS, TF32_FLOPS, HBM_BYTES_PER_S = 67e12, 495e12, 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def events_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean CUDA-event time of fn() over `iters` back-to-back calls.  For a
    function of a few microseconds of work this is the host's launch rate,
    not the kernels' time."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean host time to enqueue one fn() (checks, allocation, launch), over
    `iters` back-to-back calls with no synchronisation between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def kernel_events(prof):
    """The device (kernel) rows of a torch.profiler run."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int = 50, warmup: int = 10):
    """Mean device time of fn(): the summed time of every kernel that
    `iters` calls launch, from torch.profiler, over `iters`.  Returns
    (ms, kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = kernel_events(prof)
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
            sorted(e.key for e in kernels))


# ---------------------------------------------------------------------------
# conv5
# ---------------------------------------------------------------------------

CONV5_SHAPES = {  # (B, Ci, D, H, W, Co)
    "main": (32, 16, 8, 10, 6, 16),      # nf=8 on 41x49x35, batch 32
    "odd-batch": (3, 16, 8, 10, 6, 16),
    "mni": (4, 16, 20, 25, 20, 16),      # 91x109x91 grid
    "thin": (4, 4, 3, 4, 3, 4),          # nf=2 on 21x25x21
    "hw30": (4, 4, 5, 6, 5, 4),          # H*W % 4 != 0: the 4-byte staging path
}
TIMED_CONV5_SHAPES = ("main", "mni")


def conv5_inputs(shape, gen):
    bsz, ci, d, h, w, co = shape
    x = torch.randn((bsz, ci, d, h, w), generator=gen, device="cuda")
    bound = 1.0 / np.sqrt(27 * ci)  # torch-default init bound
    wt = (torch.rand((co, ci, 3, 3, 3), generator=gen, device="cuda") * 2 - 1) * bound
    b = (torch.rand((co,), generator=gen, device="cuda") * 2 - 1) * bound
    return x, wt, b


def conv5_bounds(shape):
    """(bound_ms, bound_by, bound_tc_ms): the fp32-FMA floor, and the floor
    of the same work as split TF32 (3 products) on the tensor cores; each
    against the bytes floor (each input read once, the output written once)."""
    bsz, ci, d, h, wd, co = shape
    n_out = bsz * co * (d - 2) * (h - 2) * (wd - 2)
    flops = 2.0 * n_out * 27 * ci
    bytes_s = 4.0 * (bsz * ci * d * h * wd + co * ci * 27 + co + n_out) / HBM_BYTES_PER_S
    fma_s, tc_s = flops / FP32_FLOPS, 3 * flops / TF32_FLOPS
    return (1e3 * max(fma_s, bytes_s), "operations" if fma_s >= bytes_s else "bytes",
            1e3 * max(tc_s, bytes_s))


def check_conv5(conv5_mod):
    """Kernel vs plain on the card; returns (max_abs_err at the main shape, timings)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    main_err, timing = None, {}
    for name, shape in CONV5_SHAPES.items():
        x, w, b = conv5_inputs(shape, gen)
        got = conv5_mod.conv5_cuda(x, w, b)
        torch.cuda.synchronize()
        want = conv5_mod.conv5_plain(x, w, b)
        err = float((got - want).abs().max())
        # fp32 sums of 27*Ci products in another order: 2e-5 at unit scale
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        path = "16-byte" if conv5_mod.vector_staging(x) else "4-byte"
        print(f"conv5 {name} {tuple(x.shape)} -> {tuple(got.shape)} ({path} staging, "
              f"{conv5_mod.plan(*x.shape[:2], w.shape[0], *x.shape[2:]).blocks} blocks): "
              f"max_abs_err {err:.3e} (tol {tol:.1e})")
        if not err <= tol:
            fail(f"conv5 kernel disagrees with its plain version at {name}")
        # backward through the autograd Function vs autograd of the plain version
        xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        xp = [t.clone().requires_grad_(True) for t in (x, w, b)]
        g = torch.randn(want.shape, generator=gen, device="cuda")
        gk = torch.autograd.grad(conv5_mod.conv5(*xs), xs, g)
        gp = torch.autograd.grad(conv5_mod.conv5_plain(*xp), xp, g)
        gerr = max(float((a - c).abs().max() / max(1.0, float(c.abs().max())))
                   for a, c in zip(gk, gp))
        print(f"conv5 {name} grads: max scaled err {gerr:.3e} (tol 2e-4)")
        if not gerr <= 2e-4:
            fail(f"conv5 gradients disagree at {name}")
        if name == "main":
            main_err = err
        if name not in TIMED_CONV5_SHAPES:
            continue
        prefix = "" if name == "main" else f"{name}_"
        fns = {"ms": lambda: conv5_mod.conv5_cuda(x, w, b),
               "library_ms": lambda: torch.nn.functional.conv3d(x, w, b)}
        if name == "main":
            fns["plain_ms"] = lambda: conv5_mod.conv5_plain(x, w, b)
        for key, fn in fns.items():
            ms, names = device_ms(fn)
            if not ms > 0:
                fail(f"torch.profiler saw no device time for conv5 {name} {key}")
            ev, host = events_ms(fn), host_ms(fn)
            timing[prefix + key] = ms
            timing[prefix + key.replace("ms", "events_ms")] = ev
            timing[prefix + key.replace("ms", "host_ms")] = host
            print(f"conv5 {name} {key}: {ms:.5f} ms of device time a call "
                  f"(torch.profiler; {len(set(names))} kernel(s): "
                  f"{', '.join(sorted(set(names)))[:160]}); {ev:.5f} ms "
                  "a call over 200 back-to-back calls, host launch included (CUDA events); "
                  f"{host:.5f} ms of host time to enqueue a call")
        bound, by, bound_tc = conv5_bounds(shape)
        timing[prefix + "bound_ms"], timing[prefix + "bound_tc_ms"] = bound, bound_tc
        if name == "main":
            timing["bound_by"] = by
        print(f"conv5 {name} bound {bound:.5f} ms ({by}, fp32 FMA), "
              f"{bound_tc:.5f} ms as split TF32 on the tensor cores")
    return main_err, timing


def count_hmma(lib) -> int:
    """HMMA (tensor-core) instructions in a built library, from the
    toolkit's cuobjdump; fails if there is none."""
    from vaegam_tpu_torch.ops.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    n = sum("HMMA" in line for line in sass.splitlines())
    print(f"{lib.name}: {n} HMMA instructions in its SASS (cuobjdump --dump-sass)")
    if n == 0:
        fail(f"{lib.name} has no tensor-core instruction")
    return n


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def synthetic_data(config, n, seed):
    rng = np.random.default_rng(seed)
    covs = rng.normal(size=(n, config.num_covariates)).astype(np.float32)
    covs[:, 0] = (rng.uniform(size=n) > 0.5)          # task on/off
    covs[:, 7] = (rng.uniform(size=n) > 0.5)          # sex
    vols = rng.uniform(0, 1, size=(n,) + config.img_shape).astype(np.float32)
    glm = rng.normal(size=(config.img_dim, config.num_covariates + 1)).astype(np.float32)
    return vols, covs, glm


def drive_main_path(conv5_mod, profile_dir=None):
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.models import VAEGAMConfig, forward
    from vaegam_tpu_torch.train import Trainer
    from vaegam_tpu_torch.utils.tree import tree_map

    config = VAEGAMConfig()
    if not config.conv5_kernel:
        fail("the default config must route conv5 through the kernel")
    vols, covs, glm = synthetic_data(config, N_VOLS, SEED)
    trainer = Trainer(config, XU_RANGES, glm, seed=SEED, device="cuda")
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH,
                                              shuffle=True, seed=SEED, device="cuda")

    conv5_mod.conv5.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    epoch_loss = trainer.train_epoch(loader)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    step_ms, losses = [], []
    sels = list(loader.iter_index_batches())
    for i in range(TIMED_STEPS):
        c, x = loader.gather(sels[i % len(sels)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(c, x)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    forwards = len(loader) + TIMED_STEPS
    launches = conv5_mod.conv5.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack(losses).cpu().numpy()
    print(f"epoch 0: loss {epoch_loss:.4f} in {epoch_s:.2f} s; timed-step losses "
          f"{losses[0]:.1f} .. {losses[-1]:.1f}; skipped "
          f"{int(trainer.opt_state['total_notfinite'])}; gain-Cholesky fallbacks "
          f"{trainer.mvn_fallbacks}; peak memory {peak_gib:.2f} GiB")
    if not (np.isfinite(epoch_loss) and np.isfinite(losses).all()):
        fail("non-finite loss on the main path")
    print(f"conv5 launches on the main path: {launches} for {forwards} forwards")
    if launches != forwards:
        fail("conv5 did not launch once per forward on the main path")

    if profile_dir:
        profile_steps(trainer, loader, sels, profile_dir, "fp32")
        # the bf16 recipe as the CLI runs it (joint norm statistics); three
        # steps first for cuDNN's algorithm search on the bf16 shapes
        fp32_config = trainer.config
        trainer.config = dataclasses.replace(fp32_config, fused_norm_stats=True)
        trainer.set_conv_dtype(torch.bfloat16)
        for i in range(3):
            trainer.train_step(*loader.gather(sels[i % len(sels)]))
        profile_steps(trainer, loader, sels, profile_dir, "bf16")
        trainer.config = fp32_config

    # deterministic B=4 forward: card (kernels) vs CPU (plain versions).
    # The check widens the inducing grids: at the main path's grid Kuu's
    # condition number is ~1e8 and fp32 LU solves on two backends
    # legitimately diverge (tests/test_reference_parity.py:41-48).
    c, x = loader.gather(sels[0][:4])
    consts = dict(trainer.consts, xu=torch.stack([
        torch.linspace(-20.0, 20.0, config.num_inducing_pts, device="cuda")] * 6))
    with torch.no_grad():
        card, aux = forward(trainer.params, consts, c, x, config,
                            deterministic=True, return_maps=True)
        cpu_p = tree_map(lambda t: t.detach().cpu(), trainer.params)
        cpu_c = {k: v.cpu() for k, v in consts.items()}
        ref, ref_aux = forward(cpu_p, cpu_c, c.cpu(), x.cpu(), config,
                               deterministic=True, return_maps=True)
    map_err = max(float((m.cpu() - ref_aux["maps"][k]).abs().max())
                  for k, m in aux["maps"].items())
    card, ref = float(card), float(ref)
    print(f"deterministic B=4: tot_loss card {card:.6f} cpu {ref:.6f}; "
          f"maps max abs diff {map_err:.3e}")
    if not abs(card - ref) <= 1e-4 * abs(ref):
        fail("card forward disagrees with the CPU forward")
    for k, m in aux["maps"].items():
        if tuple(m.shape) != (4, config.img_dim) or not torch.isfinite(m).all():
            fail(f"map {k} has shape {tuple(m.shape)} or non-finite values")
    return launches, statistics.median(step_ms), step_ms, peak_gib


def profile_steps(trainer, loader, sels, out_dir, tag):
    """torch.profiler over 3 train steps; kernel-time table to
    out_dir/profile_steps_<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    batches = [loader.gather(sels[i % len(sels)]) for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c, x in batches:
            trainer.train_step(c, x)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    kernels = kernel_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    conv5_rows = [f"{e.key}: {e.count} calls, {e.self_device_time_total / 1e3:.5f} ms"
                  for e in kernels if "conv5_kernel" in e.key]
    with open(os.path.join(out_dir, f"profile_steps_{tag}.txt"), "w") as f:
        f.write(f"3 train steps, wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        f.write("conv5 kernel: " + ("; ".join(conv5_rows) or "no row") + "\n")
        f.write(table)
    print(f"profile {tag}: 3 steps wall {wall_ms:.3f} ms, summed kernel time "
          f"{busy_ms:.3f} ms; conv5 kernel {'; '.join(conv5_rows) or 'no row'} "
          f"({out_dir}/profile_steps_{tag}.txt)")


# ---------------------------------------------------------------------------
# the train CLI on a NIfTI study
# ---------------------------------------------------------------------------

def write_study(root: Path, img_shape, seed):
    """A 10-subject study at full width: 4D NIfTI files of raw intensities
    (100..3000 plus noise, a task block signal in a central cube), the
    design CSV in the preproc CLI's schema (motion z-scored) and a GLM-maps
    CSV with its index column.  Returns (design csv, glm csv, nii paths)."""
    import pandas as pd

    from vaegam_tpu_torch.utils import nifti
    from vaegam_tpu_torch.utils.stats import zscore

    rng = np.random.default_rng(seed)
    task = ((np.arange(STUDY_VOLS) // 10) % 2).astype(np.float32)
    cube = tuple(slice(s // 2 - 2, s // 2 + 3) for s in img_shape)
    rows, paths = [], []
    for s in range(STUDY_SUBJECTS):
        subj = f"sub-A{s:05d}"
        vols = rng.normal(0, 20, size=img_shape + (STUDY_VOLS,)).astype(np.float32)
        vols += rng.uniform(100, 3000, size=img_shape + (1,)).astype(np.float32)
        vols[cube] += 200.0 * task
        path = str(root / subj / f"{subj}_bold{'.nii.gz' if s == 0 else '.nii'}")
        nifti.save(nifti.Nifti1Image(vols, np.diag([3.0, 3.0, 3.0, 1.0])), path)
        paths.append(path)
        motion = rng.normal(0, 0.5, size=(STUDY_VOLS, 6))
        rows += [(subj, v, path, task[v], *motion[v], s % 2) for v in range(STUDY_VOLS)]
    df = pd.DataFrame(rows, columns=["subjid", "volume #", "nii_path", "task", "x", "y",
                                     "z", "rot_x", "rot_y", "rot_z", "sex"])
    design = str(root / "design.csv")
    zscore(df).to_csv(design)
    glm = str(root / "glm_maps.csv")
    pd.DataFrame(rng.normal(0, 0.1, size=(int(np.prod(img_shape)), 8))
                 .astype(np.float32)).to_csv(glm)
    return design, glm, paths


def time_decoders(paths):
    """Seconds to decode every study file with the native decoder (built
    here with make -C native; null when it does not build) and with the
    numpy codec."""
    from vaegam_tpu_torch.utils import nifti, nifti_native

    native_dir = Path(__file__).resolve().parent / "native"
    proc = subprocess.run(["make", "-C", str(native_dir)], capture_output=True, text=True)
    print(f"make -C native: exit {proc.returncode}"
          + ("" if proc.returncode == 0 else f"\n{proc.stderr.strip()[-800:]}"))
    out = {"decoder": "native" if nifti_native.available() else "numpy"}
    t0 = time.perf_counter()
    want = [np.asarray(nifti.load(p).dataobj, np.float32) for p in paths]
    out["numpy_decode_s"] = time.perf_counter() - t0
    out["native_decode_s"] = None
    if out["decoder"] == "native":
        t0 = time.perf_counter()
        got = nifti_native.decode_many_f32(paths)
        out["native_decode_s"] = time.perf_counter() - t0
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail("the native decoder and the numpy codec disagree")
    print(f"decoders on {len(paths)} files ({sum(a.nbytes for a in want) / 2**20:.0f} MiB "
          f"of fp32): numpy codec {out['numpy_decode_s']:.3f} s, native "
          f"{out['native_decode_s']} s; the CLI uses the {out['decoder']} decoder")
    return out


def run_cli(conv5_mod, argv, what):
    """One CLI run with conv5's count set to 0 just before it; returns
    (trainer, loaders, conv5 launches)."""
    from vaegam_tpu_torch.cli.train import main as cli_main

    conv5_mod.conv5.launches = 0
    trainer, loaders = cli_main(argv)
    torch.cuda.synchronize()
    launches = conv5_mod.conv5.launches
    losses = [v for d in trainer.loss.values() for v in d.values()]
    if not losses or not np.isfinite(losses).all():
        fail(f"non-finite or missing loss in the CLI's {what} run: {trainer.loss}")
    return trainer, loaders, launches


def epoch_numbers(trainer, epochs, n_vols):
    """First-epoch seconds apart from the steady ones (median) and the
    steady rate."""
    secs = [trainer.epoch_seconds[e] for e in epochs]
    steady = statistics.median(secs[1:]) if len(secs) > 1 else None
    return {"epoch_s": secs, "first_epoch_s": secs[0], "steady_epoch_s": steady,
            "steady_vols_per_s": None if steady is None else n_vols / steady}


def drive_cli(conv5_mod):
    """Phase 5; returns (conv5 launches by CLI run, the CLI's numbers)."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.train import Trainer, load_checkpoint
    from vaegam_tpu_torch.utils.jax_params import params_to_jax
    from vaegam_tpu_torch.utils.tree import tree_items

    config = VAEGAMConfig()
    root = Path(tempfile.mkdtemp(prefix="vaegam_study_"))
    try:
        t0 = time.perf_counter()
        design, glm, paths = write_study(root, config.img_shape, SEED)
        print(f"wrote the study ({STUDY_SUBJECTS} subjects x {STUDY_VOLS} volumes) in "
              f"{time.perf_counter() - t0:.1f} s")
        numbers = time_decoders(paths)
        n_vols = STUDY_SUBJECTS * STUDY_VOLS
        steps = -(-n_vols // BATCH)

        def argv(save_dir, *extra):
            return ["--train_csv", design, "--test_csv", design, "--glm_maps", glm,
                    "--save_dir", str(root / save_dir), "--batch-size", str(BATCH),
                    "--seed", str(SEED), "--test_freq", "1", "--no_outputs", *extra]

        # fp32, the default config: conv5 through the kernel
        torch.cuda.reset_peak_memory_stats()
        t, loaders, launches = run_cli(conv5_mod, argv("fp32", "--epochs", str(CLI_EPOCHS),
                                                       "--save_freq", "1"), "fp32")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        forwards = 2 * CLI_EPOCHS * steps
        print(f"CLI fp32: conv5 launches {launches} for {forwards} forwards "
              f"({CLI_EPOCHS} epochs x {steps} train and {steps} test); losses {t.loss}")
        if launches != forwards:
            fail("conv5 did not launch once per fp32 forward in the CLI run")
        ckpts = [root / "fp32" / f"checkpoint_{e:03d}.tar" for e in (1, 2)]
        if not all(p.exists() for p in ckpts):
            fail(f"missing checkpoints: {sorted(os.listdir(root / 'fp32'))}")
        built = loaders["Shuffled_train"].build_seconds
        numbers.update(cli_decode_s=built["decode"], cli_upload_s=built["upload"],
                       cache_dtype=str(loaders["Shuffled_train"].vols.dtype),
                       peak_mem_gib=peak_gib, volumes=n_vols, batch=BATCH,
                       fp32=dict(epoch_numbers(t, range(CLI_EPOCHS), n_vols),
                                 conv5_launches=launches, forwards=forwards))

        # checkpoint I/O on the fp32 trainer, and a fresh load of checkpoint_002
        save_ms, load_ms, probe = [], [], str(root / "probe.tar")
        for _ in range(3):
            t0 = time.perf_counter()
            t.save_state(probe)
            save_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            t.load_state(probe)
            torch.cuda.synchronize()
            load_ms.append(1e3 * (time.perf_counter() - t0))
        numbers.update(ckpt_save_ms=statistics.median(save_ms),
                       ckpt_load_ms=statistics.median(load_ms),
                       ckpt_mib=os.path.getsize(probe) / 2**20)
        fresh = Trainer(config, [[-1.0, 1.0]] * 6, device="cuda")
        fresh.load_state(str(ckpts[1]))
        saved = load_checkpoint(str(ckpts[1]))["params"]
        mine, _ = params_to_jax(fresh.params, None, config)
        same = all(np.array_equal(a, b) for (_, a), (_, b) in
                   zip(tree_items(mine), tree_items(saved)))
        same &= all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(tree_items(fresh.params), tree_items(t.params)))
        print(f"checkpoint: save {numbers['ckpt_save_ms']:.1f} ms, load "
              f"{numbers['ckpt_load_ms']:.1f} ms, {numbers['ckpt_mib']:.1f} MiB; "
              f"checkpoint_002 loads to the trained params: {same}")
        if not same or fresh.epoch != CLI_EPOCHS:
            fail("checkpoint_002.tar does not load to the params it saved")

        # resume with --from_ckpt for one epoch
        r, _, r_launches = run_cli(conv5_mod, argv(
            "fp32", "--epochs", "1", "--save_freq", "1", "--from_ckpt",
            "--ckpt_path", str(ckpts[1])), "resume")
        print(f"CLI resume: epochs {sorted(r.loss['train'])}, conv5 launches {r_launches}")
        if (sorted(r.loss["train"]) != list(range(CLI_EPOCHS + 1)) or r.epoch != CLI_EPOCHS + 1
                or r.loss["train"][CLI_EPOCHS - 1] != t.loss["train"][CLI_EPOCHS - 1]):
            fail("the resumed run did not continue at epoch 3 from the checkpoint")
        if r_launches != 2 * steps:
            fail("conv5 did not launch once per fp32 forward in the resumed run")
        numbers["resume"] = dict(epoch_s=r.epoch_seconds[CLI_EPOCHS],
                                 conv5_launches=r_launches, forwards=2 * steps)

        # the streaming DataLoader: a one-byte cache budget sends the CLI to it
        os.environ["VAEGAM_CACHE_MAX_BYTES"] = "1"
        try:
            st, st_loaders, st_launches = run_cli(conv5_mod, argv(
                "stream", "--epochs", "1", "--save_freq", "100"), "streaming")
        finally:
            del os.environ["VAEGAM_CACHE_MAX_BYTES"]
        kind = type(st_loaders["Shuffled_train"]).__name__
        print(f"CLI streaming ({kind}): epoch {st.epoch_seconds[0]:.2f} s, conv5 "
              f"launches {st_launches}")
        if kind != "DataLoader" or st_launches != 2 * steps:
            fail("the streaming run did not take the DataLoader through conv5")
        numbers["stream"] = dict(epoch_s=st.epoch_seconds[0], conv5_launches=st_launches)

        # the bf16 recipe: conv5 takes cuDNN's bf16 conv, as JAX takes XLA's
        b, _, b_launches = run_cli(conv5_mod, argv(
            "bf16", "--epochs", str(BF16_EPOCHS), "--save_freq", "100",
            "--conv_dtype", "bfloat16", "--fused_norm_stats"), "bf16")
        print(f"CLI bf16: losses {b.loss}; conv5 launches {b_launches}")
        if b_launches != 0:
            fail("the fp32 conv5 kernel launched on the bf16 path")
        numbers["bf16"] = dict(epoch_numbers(b, range(BF16_EPOCHS), n_vols),
                               conv5_launches=b_launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path = {"cli_fp32": launches, "cli_resume": r_launches,
               "cli_stream": st_launches, "cli_bf16": b_launches}
    return by_path, numbers



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler breakdown of 3 steps to this directory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vaegam_tpu_torch._device import configure_cuda_backends
    from vaegam_tpu_torch.ops import build, conv5 as conv5_mod

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    configure_cuda_backends()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build("conv5")
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        print(log.read_text().strip())
    count_hmma(lib)

    # 3. kernels vs plain versions
    err, timing = check_conv5(conv5_mod)

    # 4. the train step
    step_launches, step_ms, all_ms, peak_gib = drive_main_path(conv5_mod, args.profile)

    # 5. the train CLI on a NIfTI study
    cli_launches, cli = drive_cli(conv5_mod)

    # 6. numbers
    kernel = {
        "name": "conv5", "route": "cuda",
        "source": "vaegam_tpu_torch/ops/csrc/conv5.cu",
        "replaces": "vaegam_tpu/ops/pallas_conv.py:50",
        "launches": cli_launches["cli_fp32"],
        "launches_by_path": dict(train_step=step_launches, **cli_launches),
        "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "bound_tc_ms": timing["bound_tc_ms"], "events_ms": timing["events_ms"],
        "library_events_ms": timing["library_events_ms"], "host_ms": timing["host_ms"],
        "library_host_ms": timing["library_host_ms"],
        "mni_ms": timing["mni_ms"], "mni_library_ms": timing["mni_library_ms"],
        "mni_bound_ms": timing["mni_bound_ms"], "mni_bound_tc_ms": timing["mni_bound_tc_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"step_ms_median": step_ms, "vols_per_s": BATCH * 1e3 / step_ms,
                      "step_ms_min": min(all_ms), "step_ms_max": max(all_ms),
                      "batch": BATCH, "steps": TIMED_STEPS, "peak_mem_gib": peak_gib}))
    print(json.dumps({"cli": cli}))
    print(smi)
    # 7. the last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
