"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # what the check runs
    python3 chip_smoke.py --profile DIR     # also a torch.profiler breakdown of
                                            # 3 train steps, fp32 and bf16,
                                            # written under DIR

Phases, in this order but 4c, which runs after 7 (any failure exits
non-zero; nothing is caught to exit 0; phase 7's recovery verdict alone is
read after phase 12's numbers, so that a run whose oracle did not
recover still drives and reports every later phase before it exits
non-zero):
  1. the card: name and power limit (nvidia-smi), TF32 off;
  2. build every CUDA kernel of the main path (conv5, adam, convt5) from this
     checkout's sources;
  2b. the tensor-core instructions (HMMA) in the built conv5 library;
  3. each kernel against its plain PyTorch version on the card, forward and
     backward, at every shape the main path gives it (batch 32, the study's
     last batch of 20, --eval_batch_size 128 and its last batch of 84,
     phase 4's B=4 forward, the oracle's last batch of 2, phase 9's
     per-rank 16 and 10, phase 10's 98, MNI 8, 2 and 1, thin 8) and a few
     others (both of conv5's staging paths); phases 4-10 record the shape
     of every launch and fail on one this phase did not check;
     device time of conv5 and F.conv3d at the main and MNI shapes, with
     the CUDA-event time of 200 back-to-back calls and the host time to
     enqueue one call beside it;
 3c. the convt5 kernels (the decoder's output layer: a forward, a fused
     gradient pass and its reduction) against their plain version in
     float64 at the cells' shapes (ref41 and MNI, 288 decoder rows and their
     tails) and a few others: y, gx, gw and gb within 1e-3 of each one's
     largest entry and at most 3x the stock op's worst, two runs bit for
     bit; their device time and the stock F.conv_transpose3d's against the
     bytes bound at ref41 and MNI;
 3b. the Adam kernel (two launches a step) against adam_plain on two
     copies of the ref41 model's 63 leaves on the card, fp32 and with a
     float64 epsilon, and of the MNI grid's (portbench's mni91-train-eager,
     91x109x91, ~52 M parameters), over ADAM_STEPS steps, one with a NaN
     gradient:
     parameters, moments and counters bit for bit (SHA-256) after every
     step, two launches a step, the NaN step skipped and counted; the
     device time a step of both (torch.profiler; the kernel also from
     CUDA-graph replays), the host time to enqueue one, and the kernel's
     bound (32 B a float32 parameter at HBM_BYTES_PER_S);
  4. the train step at the reference's full width: a Trainer at the default
     config (nf=8, 32 latents, 41x49x35, fp32, per-one-hot decoder norm
     statistics, GLM maps on, conv5 kernel on) trains one epoch over 128
     synthetic volumes held on the card (batch 32, 4 steps), then 20 timed
     steps; every loss must be finite, conv5 must have launched once per
     forward, convt5's kernels three times a step and the Adam kernel twice
     a step.  One deterministic B=4 forward on the card must match the
     same model's CPU forward (plain kernels), on well-conditioned inducing
     grids: tot_loss rtol 1e-4;
 4b. a float64 model at the same width (JAX's partial float64: norm
     statistics and sigmoid in float32; conv5_kernel off) takes one step
     (forward, backward, Adam) from a host batch of 32 on the card and the
     same step on the CPU with the same weights and noise: loss within rtol
     F64_LOSS_RTOL, the gradients (the first Adam moment) within
     F64_GRAD_SHARE of each leaf's largest entry; then 5 timed steps on the
     card; conv5 must not launch, the Adam kernel (float64 leaves) twice a
     card step;
 4c. the Trainer's epoch_scan (a CUDA graph of the gather-fused step per
     batch width, captured after the width's first eager step and replayed
     for every later one) at full width on phase 4's 128 volumes and 2
     more, held on the card (batch 32: four steps and a tail of 2).  Under
     deterministic algorithms an eager Trainer and a replaying one from one
     seed train 3 epochs: every epoch loss, the parameters' SHA-256, the
     Adam moments and the four counters must agree bit for bit, each width
     must be captured once and every later step replayed, and conv5 must
     run once a forward (launches outside a graph plus replays of its one
     captured launch).  On the default backends: 4 epochs each in turns
     (the steady s/epoch and ms/step, the first apart), the graphs' memory
     pool, one profiled epoch each (conv5's kernel events must equal its
     launches plus replays; the host's cudaStreamSynchronize calls), and 2
     bf16 epochs replayed against 2 eager ones (losses rtol 1e-4, no conv5).
     On every run the Adam kernel runs twice a step (its launches outside a
     graph plus two a replay, two captured a graph); in the profiled
     epochs its counters advance once a step, and its kernel events equal
     that count eager and do not pass it replayed (the profiler can keep
     part of a replayed graph's records);
  5. the train CLI on a NIfTI study: a 10-subject study at the reference
     grid (98 volumes a subject, 980 in all, one subject .nii.gz, the rest
     .nii) is written with the port's NIfTI codec, with its design and GLM
     maps CSVs; the native decoder is built (make -C native) and both
     decoders are timed on it; then ``vaegam_tpu_torch.cli.train.main``
     runs on the card: fp32, batch 32, 3 epochs, test and save every epoch,
     TensorBoard at the CLI's defaults (figures at batch 0 of every epoch),
     --no_outputs (conv5 must launch once per train and test forward and
     once per figure batch, every loss be finite, checkpoint_001/002.tar
     exist); a fresh Trainer loads checkpoint_002.tar to the same params;
     the CLI resumes from it with --from_ckpt for 1 epoch (epoch 3,
     --log_figs_every 0) and then runs the whole output stage at batch 32
     on the fp32 wire: latent encode and UMAP, GP plots, 9,800 per-volume
     NIfTI maps, averaged maps (conv5 once per train, test, latent and
     recon forward); the recon stage is then timed again over the study
     without its pipeline (a blocking copy per batch) and with it, in the
     order synchronous, pipelined, pipelined, synchronous; 1 epoch on the
     streaming prefetch loader (a one-byte cache budget) on each of the
     float32 and float16 wires (conv5 once per train and test forward and
     figure batch); then 2 epochs of the bf16 recipe (--conv_dtype bfloat16
     --fused_norm_stats; no conv5 launch, the figure forward is bf16 too);
  6. a second output-stage run: --from_ckpt checkpoint_002 --recons_only
     --recon_wire_dtype float16 --eval_batch_size 128.  Each output-stage
     run is checked: the file tree (10 subjects x 98 volumes x 10 maps, 10
     maps x 11 averages, 6 GP CSVs of 980 rows sorted by xq, the PDFs and
     the TensorBoard event file where their libraries import), every map
     decoded finite float32 at 41x49x35, task_avg.nii of one subject and of
     the grand mean recomputed from the written files in float64 bit for
     bit, the GP CSVs against a CPU float64 evaluation of the same
     parameters, the UMAP backend (native, its layout on the card); the
     first run's tree is deleted before the second.  The native UMAP on the
     card must pass the JAX package's gates on its two-cluster fixture;
 6b. the checkpoint converters: checkpoint_002 exported to the reference's
     torch format and imported back must give its params bit for bit, and
     a B=32 fp32 maps forward of the round trip must equal the original's
     bit for bit on the card, on cuDNN's deterministic algorithms (conv5
     twice);
  7. the correctness oracle at every default:
     ``vaegam_tpu_torch.tools.control_experiment.main(["--work_dir", W,
     "--epochs", "900"])`` in this process (1 subject x 98 volumes, full
     width, fp32, GLM regularizer, qu_s_cholesky, fused norm statistics):
     it must exit 0 with "recovered": true and finite metrics, and launch
     conv5 exactly once per train and recon forward (900 x 4 + 4 = 3,604,
     at B = 32 and 2); its JSON line, its verdict and its seconds by stage
     are printed, and its skips and gain-Cholesky fallbacks beside them;
 7b. the oracle at the same defaults for 30 epochs with --no_gate, once
     eager and once with --epoch_scan, from the same initial weights: the
     steady s/epoch of each and conv5 once a train and recon forward (no
     recovery gate: a timing);
  8. the beta_maps CLI on a synthetic FSL tree at the reference grid (10
     subjects x 98 volumes, an exact linear model): the float64 host solve
     and the float32 solve on the card, each CSV against the ground truth,
     each timed;
  9. data parallel (vaegam_tpu_torch.parallel) at the reference defaults:
     9a. two ranks spawned by the script share the card over gloo (CUDA
     tensors), each holding phase 4c's 130 volumes, global batch 32 (16 a
     rank): the first step against a single-process step from the same
     parameters and noise, in float64 (loss DP_F64_LOSS_RTOL, each gradient
     leaf DP_F64_GRAD_SHARE of its largest entry) and in fp32 (loss
     DP_LOSS_RTOL, the JAX DP test's; the fp32 gradients printed beside
     both steps' distance from float64); on the wide inducing grids
     DP_XU_RANGES, the main path's grids printed beside them; 8 steps in
     all, the parameters' and moments' SHA-256 equal on both ranks, the
     per-rank step time;
     9b. a world of one over NCCL (what --data_parallel gives on a
     one-card machine) under epoch_scan on the same volumes: replay equals
     eager bit for bit under deterministic algorithms, every step's
     collectives recorded into each width's graph, NCCL's kernel events
     the same replayed as eager, conv5's kernel events equal to its
     launches plus replays;
     9c. the train CLI with --multihost (VAEGAM_* variables), two ranks on
     the card, on phase 5's study with phase 5's arguments for 2 epochs
     and then the output stage: both ranks' losses equal and within
     DP_CLI_RTOL of phase 5's (the JAX multi-process CLI test's bound), the
     checkpoint, GP CSVs, 9,800 recon maps and 110 averaged maps written
     once, by rank 0, conv5 once a forward on each rank; the ranks report
     their conv5 launch shapes, which phase 3 must have checked;
 10. conv_pack (lane-packed stride-1 convs) and the study tools, at the
     reference defaults unless said:
     10a. packs (2,2) and (4,4): encode at batch 32 and the 288-row decode
     against the unpacked stacks on the same parameters (in float64 the
     outputs and gradients, in fp32 the outputs, at the JAX test's bounds
     PACK_OUT_TOL / PACK_GRAD_TOL; the packed fp32 gradients against
     float64 within FP32_GRAD_SHARE of each leaf and FP32_GRAD_VS_UNPACKED
     times the unpacked arm's); one float64 step (conv5 off) packed
     against unpacked (loss DP_F64_LOSS_RTOL, gradients DP_F64_GRAD_SHARE);
     on phase 4c's volumes an unpacked epoch_scan run, then for each pack
     an eager epoch, PACK_AB_STEPS steps timed in turns with unpacked ones
     (conv5's launches counted by trainer) and PACK_SCAN_EPOCHS replayed
     epochs (one capture a width, conv5 once a forward); the bf16 recipe packed (2,2) against unpacked (first-step
     loss, maps, PACK_BF16_EPOCHS epochs each, no conv5);
     10b. tools.bench_packed_conv --iters 10 at packs (2,2) and (4,4)
     (per layer, 288 rows);
     10c. tools.conv5_fullstep_study: the step with the conv5 kernel
     against cuDNN's conv5, eager and replayed, 2 rounds of 20 steps;
     10d. tools.bench_recon on 1 subject x 98 volumes at widths 32 and 128;
     10e. tools.epsilon_precision_study (20 steps) and
     tools.beta_solve_precision_study (10 subjects, 70,315 voxels);
     10f. at the MNI grid, batch 8: tools.bench_mni_prefetch (2 subjects x
     49 volumes, DataLoader against PrefetchLoader, a warm-up and 1 timed
     epoch each), tools.epoch_scan_diagnosis (4 replayed epochs, a probe
     every 3) and tools.mni_mesh_dryrun at 2 ranks sharing the card over
     gloo (the full MNI model, one row a rank, its conv5 launch shape
     checked in phase 3); conv5 must run once a forward on each path that
     has it;
 11. the TPU's product arithmetic (``VAEGAMConfig(tpu_products=True)``:
     both operands of every product rounded to bfloat16, float32 sums,
     forward and backward), at the oracle's config:
     11a. conv5's one-pass path (``conv5_cuda(..., one_pass=True)``)
     against ``F.conv3d`` on rounded operands (TF32 off) at the shapes the
     arm launches and a few others (atol 2e-5 at unit scale; it must sit
     further than 10x that from the full float32 conv), its backward, its
     HMMA count beside the split path's, and device times of the path, the
     split path, the plain version and ``F.conv3d`` at the main and MNI
     shapes;
     11b. one full-width step in the arm (fp32, conv5 one-pass) against the
     same step in float64 in the arm (same weights, noise and sites): loss
     within TPU_LOSS_RTOL, each gradient leaf within its group's bound
     (TPU_GRAD_GROUPS) of its largest entry, also in the arm's step again
     and on cuDNN's deterministic algorithms; the unrounded fp32 loss at
     least TPU_LIVE_RATIO times further and its gradient beyond the bound on
     TPU_LIVE_LEAVES; 29 / 29 / 27 product sites by kind in both, none
     without the arm, conv5 once;
     11c. 30 oracle epochs in the arm (``--tpu_products``), eager and under
     ``--epoch_scan``: every loss finite, skips and fallbacks printed,
     conv5 once a train and recon forward; every one-pass launch shape
     checked in 11a;
 12. one JSON line with the seconds of each phase and of the whole run
     (after the imports) beside the card, then one JSON line with phase
     10's numbers, one with phase 11's, one
     with the kernels' numbers (conv5's launches by path, convt5's runs by
     path and its phase 3c numbers,
     the epoch_scan paths' as launches plus replays, the ranks'; adam's
     runs by path of phases 4-4c, its phase 3b times and bound, its device
     ms a step in 4c's profiled eager epoch), one with
     the step time, one with the float64 step, one with epoch_scan's
     (phases 4c and 7b), one with the CLI's numbers (converters included),
     one with the output stage's numbers, one with the oracle's, one with
     beta_maps' and one with data parallel's; then phase 7's verdict;
 13. as the last line: {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import queue
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
ORACLE_EPOCHS, ORACLE_VOLS = 900, 98   # the oracle's gate at its defaults
CLI_EPOCHS, BF16_EPOCHS = 3, 2
WIDE_EVAL_BATCH = 128                  # the output stage's --eval_batch_size run
XU_RANGES = [[-2.0, 2.0]] * 6          # as bench.py
DP_RANKS, DP_STEPS, DP_TIMED_STEPS, DP_CLI_EPOCHS = 2, 3, 5, 2
# the fp32 bounds of the JAX package's DP test (tests/test_parallel.py:202-237)
# and of its 2-process CLI test (tests/test_multihost.py:240-243)
DP_LOSS_RTOL, DP_CLI_RTOL = 2e-5, 2e-3
# phase 9a holds the two-rank step's gradients to the single-process one's
# in float64, at the float64 bounds of tests/test_torch_port_parallel.py:
# at full width the fp32 gradients of the two depend on which algorithms
# each process's cuDNN search picks, up to ~1e-3 of a leaf's largest entry
# (enc/bn1/scale on an H100, PERF.md §6), past the JAX test's fp32 2e-4
DP_F64_LOSS_RTOL, DP_F64_GRAD_SHARE = 1e-9, 1e-7
# phase 9a's inducing grids: wide, so that Kuu is well conditioned (as in
# phase 4's card-vs-CPU check and tests/torch_port_common.py); at XU_RANGES
# its condition number is ~1e8 and the GP leaves' fp32 gradients differ
# between any two summation orders
DP_XU_RANGES = [[-20.0, 20.0]] * 6
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


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Mean device time of fn() from CUDA events around replays of a CUDA
    graph of `iters` calls: the kernels with no host launch between them.
    Phase 11a's times: late in the run torch.profiler has kept part of a
    window or none of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ---------------------------------------------------------------------------
# conv5
# ---------------------------------------------------------------------------

N_STUDY = STUDY_SUBJECTS * STUDY_VOLS
CONV5_SHAPES = {  # (B, Ci, D, H, W, Co)
    # nf=8 on 41x49x35 at every batch width the main path gives conv5:
    # batch 32, the study's last batch at 32, --eval_batch_size 128 and its
    # last batch, phase 4's B=4 card-vs-CPU forward, and the oracle's last
    # batch (98 volumes at batch 32)
    "main": (BATCH, 16, 8, 10, 6, 16),
    "tail": (N_STUDY % BATCH, 16, 8, 10, 6, 16),
    "wide": (WIDE_EVAL_BATCH, 16, 8, 10, 6, 16),
    "wide-tail": (N_STUDY % WIDE_EVAL_BATCH, 16, 8, 10, 6, 16),
    "b4": (4, 16, 8, 10, 6, 16),
    "oracle_tail": (ORACLE_VOLS % BATCH, 16, 8, 10, 6, 16),
    "odd-batch": (3, 16, 8, 10, 6, 16),
    "mni": (4, 16, 20, 25, 20, 16),      # 91x109x91 grid
    "thin": (4, 4, 3, 4, 3, 4),          # nf=2 on 21x25x21
    "hw30": (4, 4, 5, 6, 5, 4),          # H*W % 4 != 0: the 4-byte staging path
    # phase 9's two ranks: their half of batch 32 and of the study's last batch
    "dp": (BATCH // DP_RANKS, 16, 8, 10, 6, 16),
    "dp-tail": (N_STUDY % BATCH // DP_RANKS, 16, 8, 10, 6, 16),
    # phase 10: bench_recon's width 128 over 98 volumes, the MNI tools'
    # batch 8 and their last batch of 2 (98 volumes), the epsilon study's
    # toy model at batch 8
    "recon-98": (ORACLE_VOLS, 16, 8, 10, 6, 16),
    "mni-b8": (8, 16, 20, 25, 20, 16),
    "mni-tail": (98 % 8, 16, 20, 25, 20, 16),
    "thin-b8": (8, 4, 3, 4, 3, 4),
    # mni_mesh_dryrun's ranks: one row each
    "mni-dp": (1, 16, 20, 25, 20, 16),
    # portbench's mni91-train-eager: batch 32 over 98 volumes, and its last
    # batch of 2
    "mni-b32": (32, 16, 20, 25, 20, 16),
    "mni-tail32": (98 % 32, 16, 20, 25, 20, 16),
}
TIMED_CONV5_SHAPES = ("main", "mni")


class Conv5Shapes:
    """Records the shape (B, Ci, D, H, W, Co) of every conv5 kernel launch
    while installed, those of the one-pass path also in ``one_pass``; the
    launch count stays conv5_cuda's own."""

    def __init__(self, conv5_mod):
        self.mod, self.launch = conv5_mod, conv5_mod.conv5_cuda
        self.seen, self.one_pass = set(), set()

    def __enter__(self):
        def recorded(x, w, b, one_pass=False):
            self.seen.add((*x.shape, w.shape[0]))
            if one_pass:
                self.one_pass.add((*x.shape, w.shape[0]))
            return self.launch(x, w, b, one_pass)
        self.mod.conv5_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.mod.conv5_cuda = self.launch


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
# convt5
# ---------------------------------------------------------------------------

CONVT5_SHAPES = {  # (B, Ci, D, H, W): convt5's input, 9 decoder rows a volume
    # the cells' train steps: 41x49x35 at batch 32 and the study's last batch
    # of 20, the MNI grid 91x109x91 at batch 32 and its last batch of 2
    "ref41": (9 * BATCH, 8, 39, 47, 33),
    "ref41-tail": (9 * (N_STUDY % BATCH), 8, 39, 47, 33),
    "mni": (9 * BATCH, 8, 91, 107, 89),
    "mni-tail": (9 * (98 % BATCH), 8, 91, 107, 89),
    # the thin model (nf 2, 21x25x21), and rows of a multiple of 4 words:
    # y's (W + 2) and gx's (W) 16-byte stores
    "thin": (72, 2, 19, 23, 21),
    "vec-y": (3, 4, 5, 6, 6),
    "vec-gx": (3, 3, 4, 7, 8),
}
TIMED_CONVT5_SHAPES = ("ref41", "mni")
CONVT5_SHARE = 1e-3   # ROADMAP F4: each output within 1e-3 of its largest entry


def convt5_bounds(shape):
    """(forward, backward) bytes bounds in ms (the forward reads x, writes y;
    the fused backward reads gy and x, writes gx; each tensor once) and the
    products' time at the fp32 FMA rate (2 * 216 FLOPs an output and an
    input voxel, three passes)."""
    bsz, ci, d, h, wd = shape
    nx, ny = bsz * ci * d * h * wd, bsz * (d + 2) * (h + 2) * (wd + 2)
    fwd, bwd = 4.0 * (nx + ny) / HBM_BYTES_PER_S, 4.0 * (ny + 2 * nx) / HBM_BYTES_PER_S
    return 1e3 * fwd, 1e3 * bwd, 1e3 * 2.0 * 27 * nx * 3 / FP32_FLOPS


def max_share(got, want, chunk=8):
    """max |got - want| over max |want|, in float64, `chunk` rows at a time
    (an MNI gx in float64 is 16 GB)."""
    err = big = 0.0
    for i in range(0, want.shape[0], chunk):
        w = want[i:i + chunk].double()
        err = max(err, float((got[i:i + chunk].double() - w).abs().max()))
        big = max(big, float(w.abs().max()))
    return err / max(big, 1e-30)


def check_convt5(timed=True):
    """Phase 3c: the convt5 kernels (``ops.convt5``) against their plain
    version in float64 at CONVT5_SHAPES: y, gx, gw and gb each within
    CONVT5_SHARE of its largest entry, the worst at most 3x the worst of the
    stock op (F.conv_transpose3d and its autograd, fp32, TF32 off), and two
    runs bit for bit equal; three launches a forward and backward.  Then,
    at TIMED_CONVT5_SHAPES, the device time of the forward and of the
    gradients (CUDA events; torch.profiler beside), of the stock op as the
    yardstick (``library_ms``: the port never calls it for an fp32 convt5)
    and, at ref41, of the plain version, against the bytes bound.  Returns
    the phase's numbers."""
    import torch.nn.functional as F

    from vaegam_tpu_torch.ops import convt5 as mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {}
    for name, shape in CONVT5_SHAPES.items():
        ci = shape[1]
        x = torch.randn(shape, generator=gen, device="cuda")
        bound = 1.0 / np.sqrt(27)  # torch-default init bound (fan_in = Co * 27)
        w = (torch.rand((ci, 1, 3, 3, 3), generator=gen, device="cuda") * 2 - 1) * bound
        b = (torch.rand((1,), generator=gen, device="cuda") * 2 - 1) * bound
        mod.convt5.launches = mod.convt5.captured = 0
        y = mod.convt5_cuda(x, w, b)
        gy = torch.randn(y.shape, generator=gen, device="cuda")
        kern = (y, *mod.convt5_grads_cuda(x, w, gy))
        again = (mod.convt5_cuda(x, w, b), *mod.convt5_grads_cuda(x, w, gy))
        torch.cuda.synchronize()
        launches = mod.convt5.launches
        same = all(torch.equal(a, c) for a, c in zip(kern, again))
        del again
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        ys = F.conv_transpose3d(xs, ws, bs)
        stock = (ys.detach(), *torch.autograd.grad(ys, (xs, ws, bs), gy))
        del xs, ws, bs, ys
        x64, w64, gy64 = x.double(), w.double(), gy.double()
        names = ("y", "gx", "gw", "gb")
        ref = mod.convt5_plain(x64, w64, b.double())
        shares = {"y": (max_share(kern[0], ref), max_share(stock[0], ref))}
        del ref
        for key, k, st, r in zip(names[1:], kern[1:], stock[1:],
                                 mod.convt5_plain_grads(x64, w64, gy64)):
            shares[key] = (max_share(k, r), max_share(st, r))
        del x64, gy64, kern, stock
        worst, stock_worst = (max(v[i] for v in shares.values()) for i in (0, 1))
        p = mod.plan(*shape)
        print(f"convt5 {name} {shape}: kernel / stock shares of the largest entry "
              + ", ".join(f"{k} {a:.2e} / {c:.2e}" for k, (a, c) in shares.items())
              + f"; two runs bit for bit {same}; {launches} launches; plan fx {p.fx} "
              f"fty {p.fty} ({p.fblocks} blocks), bx {p.bx} bty {p.bty} ({p.bblocks} blocks)",
              flush=True)
        if not (worst <= CONVT5_SHARE and worst <= 3 * stock_worst):
            fail(f"convt5 kernels disagree with the plain version at {name}: worst "
                 f"{worst:.3e}, the stock op's {stock_worst:.3e}")
        if not same or launches != 6:
            fail(f"convt5 at {name}: two runs equal {same}, {launches} launches (6 expected)")
        out[name] = dict(shares={k: v[0] for k, v in shares.items()},
                         stock_shares={k: v[1] for k, v in shares.items()}, same=same)
        if timed and name in TIMED_CONVT5_SHAPES:
            out[name].update(time_convt5(mod, x, w, b, gy, name == "ref41"))
        del x, w, b, gy, y
        torch.cuda.empty_cache()
    mod.convt5.launches = mod.convt5.captured = 0
    return out


def time_convt5(mod, x, w, b, gy, plain):
    """Device ms a call of the forward, the gradients and the stock op, and
    the bound; the plain version's too if `plain`.  The times are CUDA
    events over back-to-back calls (each call is milliseconds of kernels, so
    the launches hide behind them); torch.profiler's sum of kernel times is
    kept beside them with the kernels' names; it reads low where the
    profiler kept only part of its window (on an H100 it has read the MNI
    forward faster than its bytes bound allows)."""
    import torch.nn.functional as F

    iters = 20 if x.numel() < 1e9 else 5
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))

    def stock():
        return torch.autograd.grad(F.conv_transpose3d(xs, ws, bs), (xs, ws, bs), gy)

    fns = {"fwd_ms": lambda: mod.convt5_cuda(x, w, b),
           "bwd_ms": lambda: mod.convt5_grads_cuda(x, w, gy),
           "library_fwd_ms": lambda: F.conv_transpose3d(x, w, b),
           "library_ms": stock}
    if plain:
        fns["plain_ms"] = lambda: (mod.convt5_plain(x, w, b),
                                   mod.convt5_plain_grads(x, w, gy))
    t = {}
    for key, fn in fns.items():
        n = 3 if key == "plain_ms" else iters
        t[key] = events_ms(fn, iters=n, warmup=2)
        prof_ms, names = device_ms(fn, iters=n, warmup=1)
        t[key.replace("_ms", "_profiler_ms")] = prof_ms
        print(f"convt5 {tuple(x.shape)} {key}: {t[key]:.4f} ms a call (CUDA events); "
              f"torch.profiler {prof_ms:.4f} ({len(set(names))} kernel(s): "
              f"{', '.join(sorted(set(names)))[:200]})", flush=True)
    fwd_b, bwd_b, fma = convt5_bounds(tuple(x.shape))
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t.update(bound_fwd_ms=fwd_b, bound_bwd_ms=bwd_b, bound_ms=fwd_b + bwd_b, fma_ms=fma,
             roofline_pct=100 * (fwd_b + bwd_b) / t["ms"])
    print(f"convt5 {tuple(x.shape)}: kernels {t['ms']:.4f} ms (forward {t['fwd_ms']:.4f}, "
          f"gradients {t['bwd_ms']:.4f}) against a bytes bound of {fwd_b + bwd_b:.4f} ms "
          f"({fwd_b:.4f} + {bwd_b:.4f}): {t['roofline_pct']:.1f}%; products at the fp32 FMA "
          f"rate {fma:.4f} ms; the stock op {t['library_ms']:.4f} ms", flush=True)
    return t


# ---------------------------------------------------------------------------
# adam
# ---------------------------------------------------------------------------

ADAM_STEPS, ADAM_NAN_STEP, ADAM_LR = 6, 3, 1e-3   # the Trainer's lr
ADAM_EVENTS = ("adam_check", "adam_apply")         # the kernel's two functions
ADAM_MNI_SHAPE = (91, 109, 91)                     # portbench's vaegam-mni91-fp32


def adam_sides(leaves):
    """Two copies of `leaves` (the kernel's side and the plain version's),
    zero moments and fresh counters each, as a Trainer starts."""
    from vaegam_tpu_torch.ops import adam as adam_mod

    sides = []
    for _ in range(2):
        p = [t.clone() for t in leaves]
        counters = {k: torch.zeros((), dtype=d, device="cuda")
                    for k, d in zip(adam_mod.COUNTERS, adam_mod._COUNTER_DTYPES)}
        counters["last_finite"].fill_(True)
        sides.append((p, [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p],
                      counters))
    return sides


def adam_digest(side) -> str:
    """SHA-256 of a side's parameters, moments and counters."""
    import hashlib

    from vaegam_tpu_torch.ops.adam import COUNTERS

    p, m, v, counters = side
    digest = hashlib.sha256()
    for t in [*p, *m, *v, *(counters[k] for k in COUNTERS)]:
        digest.update(t.cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def convt5_runs(t, steps, what):
    """The convt5 kernels' runs on a Trainer's path (launches outside a
    graph, and three for each replay of a width's graph, three captured a
    graph), which must be three a step; kept in CONVT5_RUNS[what]."""
    from vaegam_tpu_torch.ops.convt5 import convt5

    runs = convt5.launches + 3 * sum(t.replays.values())
    if convt5.captured != 3 * sum(t.captures.values()) or runs != 3 * steps:
        fail(f"convt5's kernels ran {runs} times ({convt5.captured} captured in "
             f"{t.captures} captures) in {steps} steps ({what})")
    CONVT5_RUNS[what] = runs


CONVT5_RUNS = {}   # the convt5 kernels' runs by path, phases 4 and 4c


def adam_runs(t, launches, captured, what):
    """The Adam kernel's runs on a Trainer's path: its launches outside a
    graph, and two for each replay of a width's graph (two captured a
    graph)."""
    if captured != 2 * sum(t.captures.values()):
        fail(f"adam was captured {captured} times in {t.captures} graph captures ({what})")
    return launches + 2 * sum(t.replays.values())


def check_adam():
    """Phase 3b: the Adam kernel (``ops.adam.adam`` on card tensors)
    against ``adam_plain`` on two copies of the ref41 model's leaves on the
    card, fp32 and with a float64 epsilon, and of the MNI grid's fp32
    leaves (ADAM_MNI_SHAPE: other tile counts, block counts and ticket
    orders than ref41's): ADAM_STEPS steps, step
    ADAM_NAN_STEP with a NaN gradient; parameters, moments and counters
    equal bit for bit (SHA-256) after every step, two launches a step, the
    NaN step skipped and counted.  Then, on the fp32 leaves, the device
    time a step of both (torch.profiler; the kernel also from CUDA-graph
    replays), the host time to enqueue a step, and the kernel's bound: the
    update reads p, g, m and v and writes p, m and v, the check reads g, at
    HBM_BYTES_PER_S.  Returns the phase's numbers."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.models.vaegam import init_model
    from vaegam_tpu_torch.ops import adam as adam_mod
    from vaegam_tpu_torch.utils.tree import tree_items

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {}
    arms = (("fp32", VAEGAMConfig()), ("x64_epsilon", VAEGAMConfig(x64_epsilon=True)),
            ("mni91", VAEGAMConfig(img_shape=ADAM_MNI_SHAPE)))
    for arm, config in arms:
        params, _ = init_model(config, XU_RANGES, None, seed=SEED, device="cuda")
        leaves = [t.detach() for _, t in tree_items(params)]
        kernel, plain = adam_sides(leaves)
        work = adam_mod.workspace("cuda")
        adam_mod.adam.launches = adam_mod.adam.captured = 0
        equal = []
        for step in range(ADAM_STEPS):
            grads = [torch.randn(t.shape, generator=gen, device="cuda", dtype=t.dtype)
                     * (1 + i % 5) for i, t in enumerate(leaves)]
            if step == ADAM_NAN_STEP:
                grads[7].view(-1)[3] = float("nan")
            adam_mod.adam(kernel[0], grads, *kernel[1:], work, ADAM_LR)
            adam_mod.adam_plain(plain[0], grads, *plain[1:], ADAM_LR)
            torch.cuda.synchronize()
            equal.append(adam_digest(kernel) == adam_digest(plain))
        counters = {k: int(v) for k, v in kernel[3].items()}
        launches = (adam_mod.adam.launches, adam_mod.adam.captured)
        n = sum(t.numel() for t in leaves)
        print(f"adam {arm}: {len(leaves)} leaves, {n} parameters "
              f"({sorted({str(t.dtype) for t in leaves})}); kernel against plain over "
              f"{ADAM_STEPS} steps (step {ADAM_NAN_STEP} NaN), SHA-256 equal {equal}; "
              f"counters {counters}; launches {launches[0]}, captured {launches[1]}")
        if not all(equal):
            fail(f"the Adam kernel disagrees with adam_plain ({arm})")
        if launches != (2 * ADAM_STEPS, 0):
            fail(f"the Adam kernel did not launch twice a step ({arm})")
        if counters != dict(count=ADAM_STEPS - 1, notfinite_count=0, last_finite=1,
                            total_notfinite=1):
            fail(f"the Adam kernel's counters are not the skipped step's ({arm})")
        out[arm] = dict(leaves=len(leaves), params=n, steps_equal=equal, counters=counters)
        del params, leaves, kernel, plain, grads
    # times on the fp32 leaves, a finite gradient
    params, _ = init_model(VAEGAMConfig(), XU_RANGES, None, seed=SEED, device="cuda")
    leaves = [t.detach() for _, t in tree_items(params)]
    (kp, km, kv, kc), (pp, pm, pv, pc) = adam_sides(leaves)
    grads = [torch.randn(t.shape, generator=gen, device="cuda") for t in leaves]
    work = adam_mod.workspace("cuda")
    fns = {"ms": lambda: adam_mod.adam(kp, grads, km, kv, kc, work, ADAM_LR),
           "plain_ms": lambda: adam_mod.adam_plain(pp, grads, pm, pv, pc, ADAM_LR)}
    timing = {}
    for key, fn in fns.items():
        iters = 50 if key == "ms" else 10
        ms, names = device_ms(fn, iters=iters)
        if not ms > 0:
            fail(f"torch.profiler saw no device time for adam {key}")
        host = host_ms(fn, iters=iters)
        timing[key], timing[key.replace("ms", "host_ms")] = ms, host
        print(f"adam {key}: {ms:.5f} ms of device time a step (torch.profiler; "
              f"{len(names)} kernel(s): {', '.join(names)[:160]}); {host:.5f} ms of host "
              "time to enqueue a step")
        if key == "ms" and not (len(names) == 2 and all(
                any(f in k for k in names) for f in ADAM_EVENTS)):
            fail(f"the Adam kernel's profiled functions are {names}")
    timing["graph_ms"] = graph_ms(fns["ms"])
    nbytes = sum(8 * t.numel() * t.element_size() for t in leaves)
    timing["bound_bytes"] = nbytes
    timing["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"adam: {timing['graph_ms']:.5f} ms a step from CUDA-graph replays; bound "
          f"{timing['bound_ms']:.5f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s: 28 B a "
          f"parameter for the update, 4 for the check), "
          f"{100 * timing['bound_ms'] / timing['ms']:.1f}% of it (profiler)")
    adam_mod.adam.launches = adam_mod.adam.captured = 0
    return dict(out, **timing)


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
    from vaegam_tpu_torch.ops.adam import adam
    from vaegam_tpu_torch.ops.convt5 import convt5
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
    adam.launches = adam.captured = 0
    convt5.launches = convt5.captured = 0
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
    convt5_runs(trainer, forwards, "train_step")
    adam_launches, adam_captured = adam.launches, adam.captured
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack(losses).cpu().numpy()
    print(f"epoch 0: loss {epoch_loss:.4f} in {epoch_s:.2f} s; timed-step losses "
          f"{losses[0]:.1f} .. {losses[-1]:.1f}; skipped "
          f"{int(trainer.opt_state['total_notfinite'])}; gain-Cholesky fallbacks "
          f"{trainer.mvn_fallbacks}; peak memory {peak_gib:.2f} GiB")
    if not (np.isfinite(epoch_loss) and np.isfinite(losses).all()):
        fail("non-finite loss on the main path")
    print(f"conv5 launches on the main path: {launches} for {forwards} forwards; adam "
          f"{adam_launches} launches, {adam_captured} captured for {forwards} steps")
    if launches != forwards:
        fail("conv5 did not launch once per forward on the main path")
    if (adam_launches, adam_captured) != (2 * forwards, 0):
        fail("the Adam kernel did not launch twice a step on the main path")

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
    return launches, adam_launches, statistics.median(step_ms), step_ms, peak_gib


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
# epoch_scan: CUDA-graph replays of the gather-fused step
# ---------------------------------------------------------------------------

SCAN_VOLS = N_VOLS + 2          # phase 4's and 2 more: four steps of 32 and a tail of 2
SCAN_EPOCHS, SCAN_TIMED_EPOCHS, SCAN_BF16_EPOCHS = 3, 4, 2
BF16_LOSS_RTOL = 1e-4           # the bf16 recipe's loss tolerance in the CPU tests


def trainer_state(t):
    """(SHA-256 of the parameters' bytes in tree order, the Adam moments,
    the four counters) of a Trainer."""
    import hashlib

    from vaegam_tpu_torch.utils.tree import tree_items

    digest = hashlib.sha256()
    for _, p in tree_items(t.params):
        digest.update(p.detach().cpu().contiguous().numpy().tobytes())
    moments = [m for key in ("mu", "nu") for _, m in tree_items(t.opt_state[key])]
    counters = {k: t.opt_state[k].item() for k in ("count", "notfinite_count",
                                                    "last_finite", "total_notfinite")}
    return digest.hexdigest(), moments, counters


def profile_epoch(trainer, loader):
    """One epoch under torch.profiler: (conv5 kernel events, NCCL kernel
    events, the Adam kernel's events and their ms, summed kernel ms,
    cudaStreamSynchronize calls and their host ms, the epoch's host s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = kernel_events(prof)
    syncs = [e for e in rows if e.key == "cudaStreamSynchronize"]
    adam = [e for e in kernels if any(f in e.key for f in ADAM_EVENTS)]
    return dict(conv5_events=sum(e.count for e in kernels if "conv5_kernel" in e.key),
                nccl_events=sum(e.count for e in kernels if "nccl" in e.key.lower()),
                adam_events=sum(e.count for e in adam),
                adam_ms=sum(e.self_device_time_total for e in adam) / 1e3,
                kernel_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                stream_syncs=sum(e.count for e in syncs),
                stream_sync_ms=sum(e.cpu_time_total for e in syncs) / 1e3,
                epoch_s=wall)


def drive_epoch_scan(conv5_mod):
    """Phase 4c: the Trainer's epoch_scan (a CUDA graph per batch width,
    replayed) against its eager epochs at full width, on SCAN_VOLS volumes
    on the card (batch 32: four steps and a tail of 2).  Under
    deterministic algorithms two Trainers from one seed, one eager and one
    replaying, train SCAN_EPOCHS epochs: every epoch loss, the parameters'
    SHA-256, the Adam moments and the four counters must agree bit for bit,
    and conv5 must run once a forward (eager launches plus replays of its
    one captured launch).  Then, on the default backends, the steady epoch
    both ways (epochs alternating, the first apart), the graphs' memory
    pool, one profiled epoch each (conv5's kernel events against the
    launches plus replays counted; the eager gather's stream syncs), and
    the bf16 recipe replayed against eager bf16.  On every run the Adam
    kernel must run twice a step (launches outside a graph plus two a
    replay, two captured a graph; in the profiled epochs its counters
    advance once a step, and its kernel events equal that count eager and
    do not pass it replayed).  Returns (conv5 launches by path, the phase's
    numbers, the Adam kernel's runs by path)."""
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.ops.adam import adam
    from vaegam_tpu_torch.ops.convt5 import convt5
    from vaegam_tpu_torch.tools.common import graph_pool_mib
    from vaegam_tpu_torch.train import Trainer

    config = VAEGAMConfig()
    vols, covs, glm = synthetic_data(config, N_VOLS, SEED)      # phase 4's volumes
    more_vols, more_covs, _ = synthetic_data(config, SCAN_VOLS - N_VOLS, SEED + 1)
    loader = DeviceResidentLoader.from_arrays(
        np.concatenate([vols, more_vols]), np.concatenate([covs, more_covs]),
        batch_size=BATCH, shuffle=True, seed=SEED, device="cuda")
    steps = -(-SCAN_VOLS // BATCH)
    adam_by_path = {}

    def run(scan, epochs, cfg=config):
        t = Trainer(cfg, XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda",
                    epoch_scan=scan)
        torch.cuda.synchronize()
        conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0
        adam.launches = adam.captured = 0
        convt5.launches = convt5.captured = 0
        losses = [t.train_epoch(loader) for _ in range(epochs)]
        torch.cuda.synchronize()
        tag = f"scan_{'replay' if scan else 'eager'}_{'det' if cfg is config else 'bf16'}"
        if cfg is config:   # the bf16 recipe's convt5 is bf16: the stock op
            convt5_runs(t, epochs * steps, tag)
        adam_by_path[tag] = adam_runs(t, adam.launches, adam.captured, tag)
        if adam_by_path[tag] != 2 * epochs * steps:
            fail(f"the Adam kernel ran {adam_by_path[tag]} times in {epochs * steps} steps "
                 f"({tag})")
        return t, losses, conv5_mod.conv5.launches, conv5_mod.conv5.captured

    def path_launches(t, launches, captured):
        """conv5 runs on a path: launches outside a graph, and each replay
        of a graph that holds one (one capture a width)."""
        if captured != sum(t.captures.values()):
            fail(f"conv5 was captured {captured} times in {t.captures} graph captures")
        return launches + (sum(t.replays.values()) if captured else 0)

    out, by_path = {}, {}
    # bit for bit under deterministic algorithms (cuBLAS needs its
    # deterministic workspace setting for that)
    cublas_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        eager, eager_losses, eager_launches, _ = run(False, SCAN_EPOCHS)
        replay, replay_losses, launches, captured = run(True, SCAN_EPOCHS)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        if cublas_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas_env
    (e_sha, e_mom, e_cnt), (r_sha, r_mom, r_cnt) = trainer_state(eager), trainer_state(replay)
    same_moments = all(torch.equal(a, b) for a, b in zip(e_mom, r_mom))
    replay_launches = path_launches(replay, launches, captured)
    forwards = SCAN_EPOCHS * steps
    print(f"epoch_scan, deterministic, {SCAN_EPOCHS} epochs of {steps} steps: losses eager "
          f"{eager_losses} replay {replay_losses}; params SHA-256 {e_sha[:16]} / "
          f"{r_sha[:16]}; moments equal {same_moments}; counters {e_cnt} / {r_cnt}; "
          f"captures {replay.captures}, replays {replay.replays}; conv5 eager "
          f"{eager_launches}, replay path {launches} launches + {captured} captured "
          f"-> {replay_launches} runs for {forwards} forwards")
    if not (eager_losses == replay_losses and e_sha == r_sha and same_moments
            and e_cnt == r_cnt and np.isfinite(eager_losses).all()):
        fail("the replayed epochs disagree with the eager ones under deterministic "
             "algorithms")
    if replay.captures != {BATCH: 1, SCAN_VOLS % BATCH: 1} or \
            sum(replay.replays.values()) != forwards - 2:
        fail("epoch_scan did not capture once a width and replay every later step")
    if eager_launches != forwards or replay_launches != forwards:
        fail("conv5 did not run once a forward on the epoch_scan paths")
    by_path.update(scan_eager_det=eager_launches, scan_replay_det=replay_launches)
    out["deterministic"] = dict(losses=eager_losses, params_sha256=e_sha, counters=e_cnt,
                                captures=replay.captures, replays=replay.replays)

    # the default backends: steady epochs in turns, the graphs' pool, profiles
    del eager, replay
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trainers = {k: Trainer(config, XU_RANGES, glm, seed=SEED, enable_tb=False,
                           device="cuda", epoch_scan=k == "replay")
                for k in ("eager", "replay")}
    counts = {k: [0, 0] for k in trainers}
    adam_counts = {k: [0, 0] for k in trainers}
    pool = None
    for epoch in range(SCAN_TIMED_EPOCHS):
        for k, t in trainers.items():
            torch.cuda.synchronize()
            conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0
            adam.launches = adam.captured = 0
            t.train_epoch(loader)
            torch.cuda.synchronize()
            counts[k][0] += conv5_mod.conv5.launches
            counts[k][1] += conv5_mod.conv5.captured
            adam_counts[k][0] += adam.launches
            adam_counts[k][1] += adam.captured
            if k == "replay" and epoch == 0:
                pool = graph_pool_mib()
    timing = {}
    for k, t in trainers.items():
        secs = [t.epoch_seconds[e] for e in range(SCAN_TIMED_EPOCHS)]
        steady = statistics.median(secs[1:])
        timing[k] = dict(epoch_s=secs, steady_epoch_s=steady,
                         steady_step_ms=1e3 * steady / steps,
                         conv5_runs=path_launches(t, *counts[k]))
        if timing[k]["conv5_runs"] != SCAN_TIMED_EPOCHS * steps:
            fail(f"conv5 did not run once a forward in the timed {k} epochs")
        adam_by_path[f"scan_{k}"] = adam_runs(t, *adam_counts[k], f"timed {k}")
        if adam_by_path[f"scan_{k}"] != 2 * SCAN_TIMED_EPOCHS * steps:
            fail(f"the Adam kernel did not run twice a step in the timed {k} epochs")
    # one profiled epoch each: conv5's kernel events against the count
    for k, t in trainers.items():
        replays0 = sum(t.replays.values())
        conv5_mod.conv5.launches = 0
        adam.launches = adam.captured = 0
        decided0 = int(t.opt_state["count"]) + int(t.opt_state["total_notfinite"])
        prof = profile_epoch(t, loader)
        counted = conv5_mod.conv5.launches + sum(t.replays.values()) - replays0
        adam_counted = adam.launches + 2 * (sum(t.replays.values()) - replays0)
        # steps the kernel's check decided (applied or skipped), read from the
        # counters it writes on the card
        decided = int(t.opt_state["count"]) + int(t.opt_state["total_notfinite"]) - decided0
        adam_step_ms = prof["adam_ms"] / max(prof["adam_events"] / 2, 1)
        timing[k]["profiled"] = dict(prof, conv5_counted=counted, adam_counted=adam_counted,
                                     adam_decided=decided, adam_ms_per_step=adam_step_ms)
        print(f"epoch_scan timing, {k}: epochs {[round(v, 4) for v in timing[k]['epoch_s']]} "
              f"s, steady {timing[k]['steady_epoch_s']:.4f} s/epoch, "
              f"{timing[k]['steady_step_ms']:.2f} ms/step; profiled epoch {prof['epoch_s']:.4f} "
              f"s, kernels {prof['kernel_ms']:.2f} ms, cudaStreamSynchronize "
              f"{prof['stream_syncs']} calls, {prof['stream_sync_ms']:.2f} ms of host time; "
              f"conv5 kernel events {prof['conv5_events']}, counted {counted}; adam kernel "
              f"events {prof['adam_events']}, counted {adam_counted}, steps decided "
              f"{decided}, {adam_step_ms:.5f} ms a step")
        if prof["conv5_events"] != counted or counted != steps:
            fail(f"conv5's profiled kernel events ({prof['conv5_events']}) do not match "
                 f"its launches plus replays ({counted}) on the {k} path")
        # under replays the profiler can keep part of a graph's records, so
        # there the events may fall short of the count, never pass it
        events_ok = prof["adam_events"] == adam_counted if k == "eager" else \
            0 < prof["adam_events"] <= adam_counted
        if adam.captured or adam_counted != 2 * steps or decided != steps or not events_ok:
            fail(f"the Adam kernel did not run twice a step on the {k} path: "
                 f"{prof['adam_events']} profiled events, {adam_counted} counted, "
                 f"{adam.captured} captured, {decided} steps decided of {steps}")
        by_path[f"scan_{k}"] = timing[k]["conv5_runs"] + counted
    timing["graph_pool_mib"] = pool
    timing["captures"], timing["replays"] = trainers["replay"].captures, \
        trainers["replay"].replays
    print(f"epoch_scan: graph memory pool {pool} MiB after the first replayed epoch; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out["default"] = timing
    del trainers

    # the bf16 recipe, replayed against eager, on the default backends
    bf16 = dataclasses.replace(config, conv_dtype=torch.bfloat16, fused_norm_stats=True)
    b_eager, b_eager_losses, b_launches, _ = run(False, SCAN_BF16_EPOCHS, bf16)
    b_replay, b_replay_losses, b_replay_launches, b_captured = run(True, SCAN_BF16_EPOCHS,
                                                                   bf16)
    rel = max(abs(a - b) / abs(b) for a, b in zip(b_replay_losses, b_eager_losses))
    print(f"epoch_scan bf16: losses eager {b_eager_losses} replay {b_replay_losses} (max "
          f"rel {rel:.3e}, tol {BF16_LOSS_RTOL}); captures {b_replay.captures}, replays "
          f"{b_replay.replays}; conv5 launches {b_launches} / {b_replay_launches}, "
          f"captured {b_captured}")
    if not (np.isfinite(b_replay_losses).all() and rel <= BF16_LOSS_RTOL):
        fail("the replayed bf16 epochs are not finite or miss the eager bf16 losses")
    if b_launches or b_replay_launches or b_captured or not b_replay.replays:
        fail("the bf16 epoch_scan path launched or captured conv5, or replayed nothing")
    by_path["scan_replay_bf16"] = b_replay_launches
    out["bf16"] = dict(eager_losses=b_eager_losses, replay_losses=b_replay_losses,
                       max_rel=rel, captures=b_replay.captures, replays=b_replay.replays)
    print(f"epoch_scan: the Adam kernel's runs by path {adam_by_path} (two a step)")
    return by_path, out, adam_by_path


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

    root.mkdir(parents=True, exist_ok=True)
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
    (trainer, loaders, conv5 launches, stages): stages maps each output-stage
    function the CLI called to (its conv5 launches, its result, its
    arguments)."""
    import vaegam_tpu_torch.cli.train as cli

    stages, originals = {}, {name: getattr(cli, name)
                             for name in ("project_latent", "mk_single_volumes")}

    def counted(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = conv5_mod.conv5.launches
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = (conv5_mod.conv5.launches - before, out, args)
            return out
        return call

    for name in originals:
        setattr(cli, name, counted(name))
    try:
        conv5_mod.conv5.launches = 0
        trainer, loaders = cli.main(argv)
        torch.cuda.synchronize()
        launches = conv5_mod.conv5.launches
    finally:
        for name, fn in originals.items():
            setattr(cli, name, fn)
    losses = [v for d in trainer.loss.values() for v in d.values()]
    if not losses or not np.isfinite(losses).all():
        fail(f"non-finite or missing loss in the CLI's {what} run: {trainer.loss}")
    return trainer, loaders, launches, stages


def epoch_numbers(trainer, epochs, n_vols):
    """First-epoch seconds apart from the steady ones (median) and the
    steady rate."""
    secs = [trainer.epoch_seconds[e] for e in epochs]
    steady = statistics.median(secs[1:]) if len(secs) > 1 else None
    return {"epoch_s": secs, "first_epoch_s": secs[0], "steady_epoch_s": steady,
            "steady_vols_per_s": None if steady is None else n_vols / steady}


# ---------------------------------------------------------------------------
# the output stage
# ---------------------------------------------------------------------------

HOST_LIBRARIES = ("matplotlib", "torch.utils.tensorboard", "tensorboardX", "sklearn",
                  "scipy", "pandas")


def host_libraries():
    """Which host libraries import: matplotlib draws the PDFs and figures,
    torch.utils.tensorboard (the tensorboard package) writes the events."""
    import importlib

    libs = {}
    for name in HOST_LIBRARIES:
        try:
            importlib.import_module(name)
            libs[name] = True
        except ImportError:
            libs[name] = False
    print("host libraries importable: " + ", ".join(f"{k} {v}" for k, v in libs.items()))
    return libs


def two_clusters(n_per=60, dim=32, sep=8.0, seed=0):
    """The JAX package's UMAP fixture (tests/test_umap_native.py)."""
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(n_per, dim)), rng.normal(size=(n_per, dim))
    b[:, 0] += sep
    return np.concatenate([a, b]), np.concatenate([np.zeros(n_per), np.ones(n_per)])


def check_umap_on_card():
    """The JAX package's UMAP gates, with the layout on the card:
    trustworthiness > 0.85 at k=5 and k=15, cluster gap > 2 x spread."""
    from vaegam_tpu_torch.outputs.umap_native import trustworthiness, umap_embed

    x, labels = two_clusters()
    timings = {}
    emb = umap_embed(x, n_neighbors=15, n_epochs=200, seed=42, device="cuda",
                     timings=timings)
    ca, cb = emb[labels == 0], emb[labels == 1]
    gap = float(np.linalg.norm(ca.mean(0) - cb.mean(0)))
    spread = float(max(np.linalg.norm(ca - ca.mean(0), axis=1).mean(),
                       np.linalg.norm(cb - cb.mean(0), axis=1).mean()))
    t5, t15 = trustworthiness(x, emb, 5), trustworthiness(x, emb, 15)
    print(f"UMAP two-cluster fixture on the card: trustworthiness k=5 {t5:.4f}, k=15 "
          f"{t15:.4f} (gates > 0.85); gap {gap:.3f} vs spread {spread:.3f} (gate 2x); "
          f"layout {timings['layout_s']:.3f} s")
    if not (np.isfinite(emb).all() and t5 > 0.85 and t15 > 0.85 and gap > 2 * spread):
        fail("the native UMAP on the card misses the JAX package's gates")
    return {"trustworthiness_5": t5, "trustworthiness_15": t15, "gap": gap,
            "spread": spread, "layout_s": timings["layout_s"]}


def check_gp_csvs(trainer, design, gp_dir, prefix):
    """The GP CSVs the card wrote (fp32) against the port's CPU float64
    evaluation of the same parameters.  Returns (max error, tolerance, the
    CPU fp32 error for scale).  The error of a row is |card - f64| /
    (1 + |f64|) over mean and vars; the tolerance is 4 kappa 2^-24, kappa
    the largest condition number of the six Kuu: an fp32 solve's forward
    error scales as kappa eps, and the CPU's own fp32 evaluation of the
    same parameters reached 0.4-0.8 kappa eps on study-like grids."""
    import pandas as pd

    from vaegam_tpu_torch.models.gp import evaluate_posterior_diag, rbf_gram
    from vaegam_tpu_torch.models.vaegam import (COVARIATE_KEYS, MOTION_SLICE, gp_transforms,
                                                resolve_qu_S)
    from vaegam_tpu_torch.outputs.gp_plots import MOTION_CSV_COLS

    mot = pd.read_csv(design)[MOTION_CSV_COLS].to_numpy()
    gp64 = {k: v.detach().cpu().double() for k, v in trainer.params["gp"].items()}
    xu = trainer.consts["xu"].detach().cpu().double()
    kvar, ls = gp_transforms(gp64, trainer.config)
    args = (xu, kvar, ls, gp64["qu_m"], resolve_qu_S(gp64), torch.tensor(mot.T))
    f64, v64 = (t.numpy() for t in evaluate_posterior_diag(*args))
    f32, v32 = (t.double().numpy() for t in evaluate_posterior_diag(*(a.float() for a in args)))
    kappa = float(np.linalg.cond(rbf_gram(xu, xu, kvar, ls).numpy()).max())
    tol = 4 * kappa * 2.0**-24
    sa, std = gp64["sa"].numpy(), np.exp(gp64["logstd"].numpy())
    err = cpu_err = 0.0
    for j, name in enumerate(COVARIATE_KEYS[MOTION_SLICE]):
        frame = pd.read_csv(gp_dir / f"{prefix}_GP_{name}_full.csv")
        vals = frame[["xq", "mean", "vars"]].to_numpy()
        if len(frame) != len(mot) or not np.isfinite(vals).all() \
                or (np.diff(frame["xq"].to_numpy()) < 0).any():
            fail(f"GP CSV {name}: {len(frame)} rows, finite "
                 f"{np.isfinite(vals).all()}, or not sorted by xq")
        idx = frame.iloc[:, 0].to_numpy()
        c, xq = MOTION_SLICE.start + j, mot[idx, j]
        want = (sa[c] * xq + f64[j][idx], std[c] ** 2 * xq ** 2 + v64[j][idx])
        cpu = (sa[c] * xq + f32[j][idx], std[c] ** 2 * xq ** 2 + v32[j][idx])
        for w, got, c32 in zip(want, (frame["mean"], frame["vars"]), cpu):
            err = max(err, float(np.max(np.abs(got.to_numpy() - w) / (1 + np.abs(w)))))
            cpu_err = max(cpu_err, float(np.max(np.abs(c32 - w) / (1 + np.abs(w)))))
    print(f"GP CSVs vs CPU float64: max error {err:.3e} (tol 4 kappa eps = {tol:.3e}, "
          f"kappa {kappa:.3e}; the CPU's own fp32: {cpu_err:.3e})")
    if not err <= tol:
        fail("the card's GP posterior disagrees with the float64 evaluation")
    return err, tol, cpu_err


def check_output_stage(save_dir, prefix, design, trainer, loaders, stages, steps, libs):
    """Checks of one output-stage run (see the module docstring); returns
    its numbers, with the device time of one recon maps forward at the
    run's width (torch.profiler) and the share of the recon stage it keeps
    the card busy."""
    import pandas as pd

    from vaegam_tpu_torch.models.vaegam import COVARIATE_KEYS, MAP_KEYS, MOTION_SLICE
    from vaegam_tpu_torch.outputs.umap_native import trustworthiness
    from vaegam_tpu_torch.utils import nifti

    img_shape = tuple(trainer.config.img_shape)
    subjs = pd.read_csv(design).subjid.unique().tolist()
    lat_launches, (latent, projection, backend), _ = stages["project_latent"]
    rec_launches, _, rec_args = stages["mk_single_volumes"]
    print(f"output stage {prefix}: conv5 launches latent {lat_launches}, recon "
          f"{rec_launches} ({steps} batches of {rec_args[0].batch_size}); UMAP backend "
          f"{backend}")
    if lat_launches != steps or rec_launches != steps:
        fail(f"conv5 did not launch once per latent and recon batch ({steps} each)")
    if backend != "umap_native":
        fail(f"the study's projection came from {backend}, not the native UMAP")
    trust = trustworthiness(latent, projection, 15)

    # the file tree, and every map decoded
    t0 = time.perf_counter()
    recon_dir = save_dir / "reconstructions" / f"{prefix}_model_recons"
    if sorted(os.listdir(recon_dir)) != sorted(subjs):
        fail(f"subject dirs {sorted(os.listdir(recon_dir))}")
    files = sorted(f"recon_{k}.nii" for k in MAP_KEYS)
    n_files = 0
    for s in subjs:
        vols = sorted(os.listdir(recon_dir / s))
        if vols != sorted(f"vol_{v}" for v in range(STUDY_VOLS)):
            fail(f"{s}: {len(vols)} volume dirs")
        for v in vols:
            if sorted(os.listdir(recon_dir / s / v)) != files:
                fail(f"{s}/{v}: {sorted(os.listdir(recon_dir / s / v))}")
            for f in files:
                raw = nifti.load(str(recon_dir / s / v / f)).dataobj
                if raw.shape != img_shape or raw.dtype != np.float32 \
                        or not np.isfinite(np.asarray(raw)).all():
                    fail(f"{s}/{v}/{f}: shape {raw.shape}, dtype {raw.dtype}, or not finite")
                n_files += 1
    avg_dir = save_dir / "reconstructions" / f"{prefix}_avg_model_recons"
    avgs = sorted(f"{k}_avg.nii" for k in MAP_KEYS)
    for d in [avg_dir] + [avg_dir / s for s in subjs]:
        if sorted(f for f in os.listdir(d) if f.endswith(".nii")) != avgs:
            fail(f"averages in {d}: {sorted(os.listdir(d))}")

    # task_avg.nii recomputed from the written files: float64 sums in the
    # directory's listing order, as mk_avg_maps reads them
    def read(path):
        return np.asarray(nifti.load(str(path)).dataobj)

    grand = np.zeros(img_shape, np.float64)
    for i, s in enumerate(subjs):
        vds = os.listdir(recon_dir / s)
        acc = np.zeros(img_shape, np.float64)
        for vd in vds:
            acc += read(recon_dir / s / vd / "recon_task.nii")
        acc /= len(vds)
        if i == 0 and not np.array_equal(acc.astype(np.float32),
                                         read(avg_dir / s / "task_avg.nii")):
            fail(f"{s}/task_avg.nii is not the float64 mean of its volumes")
        grand += acc
    grand /= len(subjs)
    if not np.array_equal(grand.astype(np.float32), read(avg_dir / "task_avg.nii")):
        fail("task_avg.nii is not the mean of the subjects' means")
    check_s = time.perf_counter() - t0

    gp_dir = save_dir / f"{prefix}_GP_plots"
    gp_err, gp_tol, gp_cpu_err = check_gp_csvs(trainer, design, gp_dir, prefix)
    pdfs = [save_dir / f"{prefix}_temp.pdf"] + [
        gp_dir / f"GP_{k}_full_set.pdf" for k in COVARIATE_KEYS[MOTION_SLICE]]
    events = [f for _, _, fs in os.walk(save_dir / "run") for f in fs if "tfevents" in f]
    print(f"output stage {prefix}: {n_files} maps and {len(avgs) * (len(subjs) + 1)} "
          f"averages checked in {check_s:.1f} s; PDFs {sum(p.exists() for p in pdfs)}/7 "
          f"(matplotlib {libs['matplotlib']}); event files {len(events)} "
          f"(tensorboard {libs['torch.utils.tensorboard']}); study projection "
          f"trustworthiness k=15 {trust:.4f}")
    if libs["matplotlib"] and not all(p.exists() for p in pdfs):
        fail("a latent or GP PDF is missing though matplotlib imports")
    if libs["torch.utils.tensorboard"] and not events:
        fail("no TensorBoard event file under run/ though tensorboard imports")

    st, rec = trainer.output_stats, trainer.output_stats["recons"]
    width = rec_args[0].batch_size
    c, x = loaders["Shuffled_train"].gather(np.arange(width))
    fwd_ms, _ = device_ms(lambda: trainer.recon_maps_step(c, x), iters=10, warmup=2)
    busy = steps * fwd_ms / 1e3 / rec["seconds"]
    timers = ("loader_s", "forward_s", "buffer_wait_s", "copy_wait_s", "handover_s",
              "drain_s")
    rest = rec["seconds"] - sum(rec[k] for k in timers)
    print(f"output stage {prefix}: recon {rec['seconds']:.2f} s (loader "
          f"{rec['loader_s']:.3f}, forward enqueue {rec['forward_s']:.2f}, buffer wait "
          f"{rec['buffer_wait_s']:.2f}, copy wait {rec['copy_wait_s']:.3f}, hand-over "
          f"{rec['handover_s']:.2f}, drain {rec['drain_s']:.2f}, untimed {rest:.3f}); "
          f"one maps forward {fwd_ms:.2f} ms of device time, {steps} of them keep the "
          f"card busy {100 * busy:.1f}% of the recon stage")
    return {"prefix": prefix, "eval_batch": rec_args[0].batch_size,
            "wire": "float16" if trainer._maps_wire is not None else "float32",
            "conv5_launches": {"latent": lat_launches, "recon": rec_launches},
            "latent_encode_s": st["latent_encode_s"], "umap_s": st["umap_s"],
            "umap_knn_s": st["umap_knn_s"], "umap_fuzzy_s": st["umap_fuzzy_s"],
            "umap_init_s": st["umap_init_s"], "umap_layout_s": st["umap_layout_s"],
            "umap_backend": backend, "latent_plot_s": st.get("latent_plot_s"),
            "gp_plots_s": st["gp_plots_s"], "recon_s": rec["seconds"],
            "recon_vols_per_s": rec["volumes"] / rec["seconds"],
            "recon_gib": rec["bytes"] / 2**30,
            "recon_gb_per_s": rec["bytes"] / 1e9 / rec["seconds"],
            **{f"recon_{k}": rec[k] for k in timers}, "recon_untimed_s": rest,
            "avg_maps_s": st["avg_maps_s"], "forward_device_ms": fwd_ms,
            "recon_device_busy_share": busy,
            "trustworthiness_15": trust, "gp_max_err": gp_err, "gp_tol": gp_tol,
            "gp_cpu_fp32_err": gp_cpu_err, "files_checked": n_files}


def recon_synchronous(trainer, loader, ref_niis, save_dirs) -> float:
    """The recon stage without its pipeline, for comparison: per batch the
    maps forward, a blocking .cpu() of its 10 maps, and the same hand-over
    to the same writers.  Returns its seconds."""
    from vaegam_tpu_torch.outputs import recons

    t0 = time.perf_counter()
    writer = recons._Writer(ref_niis, save_dirs, tuple(trainer.config.img_shape))
    with writer.pool:
        futures = []
        for sample in loader:
            _, aux = trainer.recon_maps_step(*trainer._put_batch(sample))
            futures += writer.submit(sample, {k: v.cpu().numpy()
                                              for k, v in aux["maps"].items()})
        for f in futures:
            f.result()
    return time.perf_counter() - t0


def compare_recon_pipeline(trainer, loader, design, out_dir: Path):
    """Seconds of the recon stage over the whole study with the depth-2
    pipeline (outputs.recons.reconstruct) and without it, in the order
    synchronous, pipelined, pipelined, synchronous; each tree is deleted
    before the next run."""
    import pandas as pd

    from vaegam_tpu_torch.outputs import recons

    dset = pd.read_csv(design)
    ref_niis, subjs = dset.nii_path.unique().tolist(), dset.subjid.unique().tolist()
    times = {"synchronous_s": [], "pipelined_s": []}
    for i, kind in enumerate(("synchronous", "pipelined", "pipelined", "synchronous")):
        dirs = [str(out_dir / str(i) / s) for s in subjs]
        for d in dirs:
            os.makedirs(d)
        torch.cuda.synchronize()
        if kind == "pipelined":
            recons.reconstruct(trainer, loader, ref_niis, dirs)
            secs = trainer.output_stats["recons"]["seconds"]
        else:
            secs = recon_synchronous(trainer, loader, ref_niis, dirs)
        times[kind + "_s"].append(secs)
        shutil.rmtree(out_dir / str(i))
    print(f"recon stage at batch {loader.batch_size}, fp32 wire: synchronous "
          f"{times['synchronous_s']} s, depth-2 pipeline {times['pipelined_s']} s")
    return times


def span_seconds(name: str) -> dict:
    """Seconds of the recorded spans called `name`, summed by epoch."""
    from vaegam_tpu_torch.utils import spans

    out = {}
    for r in spans.records():
        if r.name == name:
            out[r.step[0]] = out.get(r.step[0], 0.0) + (r.end_ns - r.start_ns) * 1e-9
    return out


def drive_cli(conv5_mod, libs, root: Path):
    """Phases 5 and 6, under `root`; the study stays in root/"study" for
    phase 9c and the runs' files are deleted.  Returns (conv5 launches by
    CLI run, the CLI's numbers, the output stage's numbers, (design csv,
    glm csv, root))."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.train import Trainer, load_checkpoint
    from vaegam_tpu_torch.utils import spans
    from vaegam_tpu_torch.utils.jax_params import params_to_jax
    from vaegam_tpu_torch.utils.tree import tree_items

    config = VAEGAMConfig()
    try:
        t0 = time.perf_counter()
        design, glm, paths = write_study(root / "study", config.img_shape, SEED)
        print(f"wrote the study ({STUDY_SUBJECTS} subjects x {STUDY_VOLS} volumes) in "
              f"{time.perf_counter() - t0:.1f} s")
        numbers = time_decoders(paths)
        n_vols = STUDY_SUBJECTS * STUDY_VOLS
        steps = -(-n_vols // BATCH)

        def argv(save_dir, *extra):
            return ["--train_csv", design, "--test_csv", design, "--glm_maps", glm,
                    "--save_dir", str(root / save_dir), "--batch-size", str(BATCH),
                    "--seed", str(SEED), "--test_freq", "1", *extra]

        # fp32, the default config: conv5 through the kernel; TensorBoard at
        # the CLI's defaults (figures at batch 0 of every epoch), timed by
        # its spans
        torch.cuda.reset_peak_memory_stats()
        spans.reset()
        spans.enable()
        try:
            t, loaders, launches, _ = run_cli(conv5_mod, argv(
                "fp32", "--epochs", str(CLI_EPOCHS), "--save_freq", "1", "--no_outputs"),
                "fp32")
        finally:
            spans.disable()
        tb_s, figure_s = span_seconds("train.tb"), span_seconds("train.figures")
        spans.reset()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        forwards = 2 * CLI_EPOCHS * steps + CLI_EPOCHS
        print(f"CLI fp32: conv5 launches {launches} for {forwards} forwards "
              f"({CLI_EPOCHS} epochs x {steps} train and {steps} test, and one figure "
              f"batch an epoch); losses {t.loss}; TensorBoard s an epoch: epoch end "
              f"{tb_s}, figure batches {figure_s}")
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
                                 train_losses=[t.loss["train"][e] for e in range(CLI_EPOCHS)],
                                 conv5_launches=launches, forwards=forwards,
                                 tb_epoch_end_s=[tb_s[e] for e in range(CLI_EPOCHS)]))

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

        # resume with --from_ckpt for one epoch without figures, then the
        # whole output stage at the training width on the fp32 wire
        r, r_loaders, r_launches, r_stages = run_cli(conv5_mod, argv(
            "fp32", "--epochs", "1", "--save_freq", "1", "--log_figs_every", "0",
            "--from_ckpt", "--ckpt_path", str(ckpts[1])), "resume")
        print(f"CLI resume: epochs {sorted(r.loss['train'])}, conv5 launches {r_launches}")
        if (sorted(r.loss["train"]) != list(range(CLI_EPOCHS + 1)) or r.epoch != CLI_EPOCHS + 1
                or r.loss["train"][CLI_EPOCHS - 1] != t.loss["train"][CLI_EPOCHS - 1]):
            fail("the resumed run did not continue at epoch 3 from the checkpoint")
        if r_launches != 4 * steps:
            fail("conv5 did not launch once per train, test, latent and recon forward "
                 "in the resumed run")
        outputs = {"resume": check_output_stage(
            root / "fp32", f"{CLI_EPOCHS + 1:03d}", design, r, r_loaders, r_stages, steps,
            libs)}
        numbers["resume"] = dict(epoch_s=r.epoch_seconds[CLI_EPOCHS],
                                 conv5_launches=r_launches, forwards=4 * steps)
        shutil.rmtree(root / "fp32" / "reconstructions")
        outputs["recon_pipeline_vs_synchronous"] = compare_recon_pipeline(
            r, r_stages["mk_single_volumes"][2][0], design, root / "recon_cmp")

        # the streaming prefetch loader: a one-byte cache budget sends the CLI
        # to it, once on the float32 wire and once on the float16 wire
        os.environ["VAEGAM_CACHE_MAX_BYTES"] = "1"
        stream = {}
        try:
            for wire in ("float32", "float16"):
                st, st_loaders, st_launches, _ = run_cli(conv5_mod, argv(
                    f"stream_{wire}", "--epochs", "1", "--save_freq", "100", "--no_outputs",
                    "--stream_dtype", wire), f"streaming {wire}")
                loader = st_loaders["Shuffled_train"]
                kind = type(loader).__name__
                print(f"CLI streaming ({kind}, {getattr(loader, 'transfer_dtype', None)} "
                      f"wire): epoch {st.epoch_seconds[0]:.2f} s (the synchronous "
                      f"DataLoader's was 3.21-3.52 s, PERF.md), conv5 launches {st_launches}")
                if (kind != "PrefetchLoader" or loader.transfer_dtype != wire
                        or st_launches != 2 * steps + 1):
                    fail(f"the streaming run did not take the {wire} prefetch loader "
                         "through conv5 once per train and test forward and figure batch")
                stream[wire] = dict(epoch_s=st.epoch_seconds[0], conv5_launches=st_launches)
        finally:
            del os.environ["VAEGAM_CACHE_MAX_BYTES"]
        numbers["stream"] = stream

        # the bf16 recipe: conv5 takes cuDNN's bf16 conv, as JAX takes XLA's;
        # the figure forward is bf16 too
        b, _, b_launches, _ = run_cli(conv5_mod, argv(
            "bf16", "--epochs", str(BF16_EPOCHS), "--save_freq", "100", "--no_outputs",
            "--conv_dtype", "bfloat16", "--fused_norm_stats"), "bf16")
        print(f"CLI bf16: losses {b.loss}; conv5 launches {b_launches}")
        if b_launches != 0:
            fail("the fp32 conv5 kernel launched on the bf16 path")
        numbers["bf16"] = dict(epoch_numbers(b, range(BF16_EPOCHS), n_vols),
                               conv5_launches=b_launches)

        # 6. the output stage alone from checkpoint_002, wide, float16 wire
        wide_steps = -(-n_vols // WIDE_EVAL_BATCH)
        w, w_loaders, w_launches, w_stages = run_cli(conv5_mod, argv(
            "wide", "--from_ckpt", "--ckpt_path", str(ckpts[1]), "--recons_only",
            "--recon_wire_dtype", "float16", "--eval_batch_size", str(WIDE_EVAL_BATCH)),
            "recons-only float16")
        print(f"CLI recons-only float16 wire, eval batch {WIDE_EVAL_BATCH}: conv5 "
              f"launches {w_launches}")
        if w_launches != 2 * wide_steps or w.epoch != CLI_EPOCHS:
            fail("the recons-only run did not launch conv5 once per latent and recon "
                 f"batch at epoch {CLI_EPOCHS}")
        outputs["wide_f16"] = check_output_stage(
            root / "wide", f"{CLI_EPOCHS:03d}", design, w, w_loaders, w_stages, wide_steps,
            libs)
        outputs["tensorboard"] = {
            "epoch_end_s": numbers["fp32"]["tb_epoch_end_s"],
            "figure_batch_s": [figure_s[e] for e in range(CLI_EPOCHS)]}
        outputs["umap_fixture"] = check_umap_on_card()
        outputs["host_libraries"] = libs

        # the checkpoint converters on checkpoint_002
        conv_launches, numbers["converters"] = drive_converters(
            conv5_mod, ckpts[1], loaders["UnShuffled_train"], root / "convert")
    finally:
        for run in root.iterdir():
            if run.name != "study":
                shutil.rmtree(run, ignore_errors=True)
    by_path = {"cli_fp32": launches, "cli_resume": r_launches,
               "cli_stream_f32": stream["float32"]["conv5_launches"],
               "cli_stream_f16": stream["float16"]["conv5_launches"],
               "cli_bf16": b_launches, "cli_recons_wide_f16": w_launches,
               "converters": conv_launches}
    return by_path, numbers, outputs, (design, glm, root)


def drive_converters(conv5_mod, ckpt: Path, loader, out_dir: Path):
    """Phase 6b: checkpoint_002 exported to the reference's torch format and
    imported back; the params must come back bit for bit, and a B=32 fp32
    maps forward of the round-tripped checkpoint must equal the original's
    bit for bit on the card (cuDNN's deterministic algorithms), through
    conv5.  Returns (conv5 launches, the
    phase's numbers)."""
    from vaegam_tpu_torch.cli import export_torch_ckpt, import_torch_ckpt
    from vaegam_tpu_torch.models import VAEGAMConfig, forward
    from vaegam_tpu_torch.train import load_checkpoint
    from vaegam_tpu_torch.utils.jax_params import params_from_jax
    from vaegam_tpu_torch.utils.tree import tree_items

    out_dir.mkdir()
    ref, back = out_dir / "reference.tar", out_dir / "checkpoint_002.tar"
    t0 = time.perf_counter()
    export_torch_ckpt.convert(str(ckpt), str(ref))
    t1 = time.perf_counter()
    import_torch_ckpt.convert(str(ref), str(back), nf=8)
    t2 = time.perf_counter()
    orig, circ = load_checkpoint(str(ckpt)), load_checkpoint(str(back))
    a, b = tree_items(orig["params"]), tree_items(circ["params"])
    same = [p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    config = VAEGAMConfig()
    covs, x = loader.gather(np.arange(BATCH))
    torch.cuda.synchronize()
    conv5_mod.conv5.launches = 0
    maps = []
    # two forwards of one model on the card agree bit for bit only on cuDNN's
    # deterministic algorithms: the transposed convs' fastest data-gradient
    # kernels accumulate with atomics (ROADMAP F2)
    torch.backends.cudnn.deterministic = True
    try:
        for state in (orig, circ):
            params, consts = params_from_jax(state["params"], state["consts"], config,
                                             "cuda")
            with torch.no_grad():
                maps.append(forward(params, consts, covs, x, config, deterministic=True,
                                    return_maps=True)[1]["maps"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    launches = conv5_mod.conv5.launches
    equal = all(torch.equal(maps[0][k], maps[1][k]) for k in maps[0])
    print(f"converters: export {t1 - t0:.2f} s ({ref.stat().st_size / 2**20:.1f} MiB), "
          f"import {t2 - t1:.2f} s; params back bit for bit: {same}; B={BATCH} maps "
          f"forward of the round trip equal to the original's bit for bit: {equal}; "
          f"conv5 launches {launches}")
    if not same or not equal:
        fail("the export/import round trip did not give back checkpoint_002")
    if launches != 2:
        fail("conv5 did not launch once per maps forward of the converter phase")
    return launches, dict(export_s=t1 - t0, import_s=t2 - t1, params_equal=same,
                          maps_equal=equal, conv5_launches=launches)


# ---------------------------------------------------------------------------
# float64
# ---------------------------------------------------------------------------

F64_TIMED_STEPS = 5
# card against CPU, float64 model (its norm statistics float32, as JAX's):
# loss rtol and the first Adam moment (0.1 x the gradient) as a share of
# each leaf's largest entry.  Read on an H100: loss 1.5e-9, gradients
# 1.07e-4 (the float32 statistics' last bits, CUDA's sums against the
# CPU's); the bounds keep a margin of ~60 and ~9 over them
F64_LOSS_RTOL, F64_GRAD_SHARE = 1e-7, 1e-3


def drive_float64(conv5_mod):
    """Phase 4b: a float64 model at full width (JAX's partial float64, conv5
    off) takes one forward, backward and Adam step on the card from a host
    batch of 32, and the same step on the CPU with the same weights and
    noise; then F64_TIMED_STEPS timed steps on the card.  conv5 must not
    launch; Adam's kernel twice a card step.  Returns (conv5 launches, the
    phase's numbers)."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.ops.adam import adam
    from vaegam_tpu_torch.models.vaegam import draw_noise
    from vaegam_tpu_torch.train import Trainer
    from vaegam_tpu_torch.utils.tree import tree_items

    config = VAEGAMConfig(dtype=torch.float64, conv5_kernel=False)
    vols, covs, glm = synthetic_data(config, BATCH, SEED)
    batch = {"covariates": covs, "volume": vols}   # as a host loader gives it
    noise = draw_noise(torch.Generator().manual_seed(SEED), BATCH, config, "cpu")
    torch.cuda.synchronize()
    conv5_mod.conv5.launches = 0
    adam.launches = adam.captured = 0
    out = {}
    for dev in ("cuda", "cpu"):
        t = Trainer(config, XU_RANGES, glm, seed=SEED, enable_tb=False, device=dev)
        c, x = t._put_batch(batch)
        t0 = time.perf_counter()
        loss, _ = t.train_step(c, x, noise=tuple(n.to(dev) for n in noise))
        loss = float(loss)
        out[dev] = (t, loss, time.perf_counter() - t0)
    card, loss_card, first_s = out["cuda"]
    cpu, loss_cpu, cpu_s = out["cpu"]
    grad_err, grad_leaf = max(
        (float((m.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-300), path)
        for (path, m), (_, w) in zip(tree_items(card.opt_state["mu"]),
                                     tree_items(cpu.opt_state["mu"])))
    dtypes = {str(p.dtype) for _, p in tree_items(card.params)}
    step_ms = []
    c, x = card._put_batch(batch)
    for _ in range(F64_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = card.train_step(c, x)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = conv5_mod.conv5.launches
    adam_launches = adam.launches
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"float64 step at B={BATCH}: loss card {loss_card!r} cpu {loss_cpu!r} "
          f"(rel {loss_rel:.3e}, bound {F64_LOSS_RTOL}); gradients (0.1 x: the first "
          f"Adam moment) max {grad_err:.3e} of each leaf's largest, at {grad_leaf} (bound "
          f"{F64_GRAD_SHARE}); parameter dtypes {sorted(dtypes)}; first step "
          f"{first_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; steady step ms "
          f"{[round(v, 2) for v in step_ms]}; conv5 launches {launches}; adam launches "
          f"{adam_launches} for {1 + F64_TIMED_STEPS} card steps")
    if dtypes != {"torch.float64"} or not np.isfinite([loss_card, float(loss)]).all():
        fail("the float64 step is not float64 throughout or not finite")
    if loss_rel > F64_LOSS_RTOL or grad_err > F64_GRAD_SHARE:
        fail("the float64 step on the card disagrees with the CPU's")
    if launches != 0:
        fail("the float32 conv5 kernel launched on the float64 path")
    if (adam_launches, adam.captured) != (2 * (1 + F64_TIMED_STEPS), 0):
        fail("the Adam kernel did not launch twice a card step on the float64 path")
    return launches, dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_rel=loss_rel,
                          adam_launches=adam_launches,
                          grad_err=grad_err, first_step_s=first_s, cpu_step_s=cpu_s,
                          step_ms=step_ms, step_ms_median=statistics.median(step_ms))


# ---------------------------------------------------------------------------
# the correctness oracle, and beta_maps
# ---------------------------------------------------------------------------

def run_oracle(argv, log: Path):
    """control_experiment.main(argv) in this process, its output to `log`;
    returns (exit code, its JSON result, the Trainer it trained)."""
    import contextlib

    import vaegam_tpu_torch.train as port_train
    from vaegam_tpu_torch.tools import control_experiment

    made, trainer = [], port_train.Trainer

    class Recorded(trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    port_train.Trainer = Recorded    # the tool imports it when it runs
    try:
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            rc = control_experiment.main(argv)
    finally:
        port_train.Trainer = trainer
        lines = log.read_text().splitlines()
        print("control_experiment " + " ".join(argv[2:]) + ": last lines of its log:\n"
              + "\n".join(line[:300] for line in lines[-4:]))
    return rc, json.loads(next(line for line in reversed(lines) if line.startswith("{"))), \
        made[-1]


def drive_oracle(conv5_mod, work: Path):
    """Phase 7: the port's control experiment at every default, in this
    process and under `work`, with conv5's count set to 0 just before it.
    Its own output goes to a log; its JSON line and the tail of the log are
    printed.  A result that is not finite or a wrong launch count fails at
    once; a run that did not recover is returned as the failure message,
    which main() raises after phase 12's numbers so that the later phases run
    and report.  Returns (conv5 launches, the tool's result, the phase's
    seconds, the failure message or None)."""
    argv = ["--work_dir", str(work / "ctl"), "--epochs", str(ORACLE_EPOCHS)]
    torch.cuda.synchronize()
    conv5_mod.conv5.launches = 0
    t0 = time.perf_counter()
    rc, result, _ = run_oracle(argv, work / "control_experiment.log")
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0
    launches = conv5_mod.conv5.launches
    steps = -(-ORACLE_VOLS // BATCH)
    want = ORACLE_EPOCHS * steps + steps
    st = result["stage_seconds"]
    print(json.dumps(result))
    print(f"oracle seconds: data generation {st['generate']:.2f}, add_signal "
          f"{st['add_signal']:.2f}, preproc {st['preproc']:.2f}, training "
          f"{st['train']:.2f}, recon {st['recon']:.2f}, averages {st['averages']:.2f}; "
          f"the whole phase {phase_s:.1f}")
    print(f"oracle: exit {rc}, recovered {result['recovered']}, contrast "
          f"{result['contrast_ratio']}, inside mean {result['task_map_mean_inside']} "
          f"(expected {result['expected_scaled_signal']}), non-finite skips "
          f"{result['nonfinite_skips']}, gain-Cholesky fallbacks {result['mvn_fallbacks']}; "
          f"conv5 launches {launches} (want {want} = {ORACLE_EPOCHS} epochs x {steps} "
          f"train forwards + {steps} recon forwards)")
    numbers = [result[k] for k in ("task_map_mean_inside", "abs_inside", "abs_outside",
                                   "contrast_ratio", "train_seconds")]
    if not np.isfinite(numbers).all() or result["epochs"] != ORACLE_EPOCHS:
        fail(f"the oracle's result is not finite or not {ORACLE_EPOCHS} epochs: {numbers}")
    if launches != want:
        fail("conv5 did not launch once per train and recon forward in the oracle")
    verdict = None
    if rc != 0 or not result["recovered"]:
        verdict = (f"the oracle did not recover the injected signal (exit {rc}, contrast "
                   f"{result['contrast_ratio']}, inside mean "
                   f"{result['task_map_mean_inside']})")
        print(f"phase 7 FAILED: {verdict}; the later phases run first", flush=True)
    return launches, result, phase_s, verdict


ORACLE_SCAN_EPOCHS = 30


def drive_oracle_scan(conv5_mod, work: Path):
    """Phase 7b: the oracle at phase 7's defaults but ORACLE_SCAN_EPOCHS
    epochs and --no_gate, under phase 7's temp dir, once eager and once
    with --epoch_scan, from the same initial weights (the tool's seed): the
    steady s/epoch of each (the median of its epochs after the first) and
    conv5's runs (launches plus replays: once a train and recon forward).
    No recovery gate: a timing.  Returns (conv5 runs by path, numbers)."""
    steps = -(-ORACLE_VOLS // BATCH)
    want = ORACLE_SCAN_EPOCHS * steps + steps
    by_path, out = {}, {}
    for scan in (False, True):
        name = "oracle_replay" if scan else "oracle_eager"
        argv = ["--work_dir", str(work / name), "--epochs", str(ORACLE_SCAN_EPOCHS),
                "--no_gate"] + (["--epoch_scan"] if scan else [])
        torch.cuda.synchronize()
        conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0
        rc, result, t = run_oracle(argv, work / f"{name}.log")
        torch.cuda.synchronize()
        captured = conv5_mod.conv5.captured
        runs = conv5_mod.conv5.launches + (sum(t.replays.values()) if captured else 0)
        secs = [t.epoch_seconds[e] for e in sorted(t.epoch_seconds)]
        steady = statistics.median(secs[1:])
        out[name] = dict(first_epoch_s=secs[0], steady_epoch_s=steady,
                         steady_step_ms=1e3 * steady / steps,
                         train_seconds=result["train_seconds"], conv5_runs=runs,
                         captures=t.captures, replays=t.replays,
                         final_loss=t.loss["train"][ORACLE_SCAN_EPOCHS - 1])
        print(f"oracle {ORACLE_SCAN_EPOCHS} epochs, {name}: exit {rc}, first epoch "
              f"{secs[0]:.3f} s, steady {steady:.4f} s/epoch ({1e3 * steady / steps:.2f} "
              f"ms/step), training {result['train_seconds']} s; captures {t.captures}, "
              f"replays {t.replays}; conv5 runs {runs} (want {want}); last loss "
              f"{out[name]['final_loss']}")
        if rc != 0 or not np.isfinite(out[name]["final_loss"]) or runs != want:
            fail(f"the {name} oracle run failed, is not finite or did not run conv5 once "
                 "a forward")
        if scan and (captured != len(t.captures) or sum(t.replays.values())
                     != ORACLE_SCAN_EPOCHS * steps - len(t.captures)):
            fail("the oracle's epoch_scan run did not replay every step after a capture")
        by_path[name] = runs
    return by_path, out


BETA_SUBJECTS, BETA_VOLS = 10, 98


def write_feat_tree(root: Path, img_shape, seed):
    """A synthetic FSL tree (tests/test_beta_maps_cli.py's, at the reference
    grid): per subject a design.mat of task, two distractors and six motion
    columns and a filtered_func_data.nii.gz from an exact linear model in
    task and motion; a sex cope map.  Returns (sex map path, the expected
    (8, voxels) maps before max-scaling)."""
    from vaegam_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    n_vox = int(np.prod(img_shape))
    true_betas = rng.normal(size=(7, n_vox))
    for s in range(BETA_SUBJECTS):
        feat = root / f"sub-A000{60 + s}" / "run1_corrected.feat"
        os.makedirs(feat)
        task = rng.integers(0, 2, BETA_VOLS).astype(float)
        full_dm = np.column_stack([task, rng.normal(size=(BETA_VOLS, 2)),
                                   rng.normal(size=(BETA_VOLS, 6))])
        rows = ["\t".join(f"{v:.6f}" for v in row) for row in full_dm]
        (feat / "design.mat").write_text("\n".join(
            [f"/NumWaves {full_dm.shape[1]}", f"/NumPoints {BETA_VOLS}", "/PPheights 1",
             "", "/Matrix"] + rows) + "\n")
        # the model on the design as written (6 decimals), so it is exact
        dm = np.loadtxt(feat / "design.mat", skiprows=5)
        data = (np.column_stack([dm[:, 0], dm[:, -6:]]) @ true_betas).T
        nifti.save(nifti.Nifti1Image(data.reshape(tuple(img_shape) + (BETA_VOLS,))
                                     .astype(np.float32), np.eye(4)),
                   str(feat / "filtered_func_data.nii.gz"))
    sex_map = rng.normal(size=img_shape).astype(np.float32)
    sex_path = root / "sex_cope.nii.gz"
    nifti.save(nifti.Nifti1Image(sex_map, np.eye(4)), str(sex_path))
    return str(sex_path), np.concatenate([true_betas, sex_map.reshape(1, -1)])


def drive_beta_maps():
    """Phase 8: the beta_maps CLI with the float64 host solve and the
    float32 solve on the card, each CSV against the ground truth, each CLI
    run and each solve alone timed."""
    import pandas as pd

    from vaegam_tpu_torch.cli import beta_maps

    img_shape = (41, 49, 35)
    root = Path(tempfile.mkdtemp(prefix="vaegam_feat_"))
    out = {"subjects": BETA_SUBJECTS, "volumes": BETA_SUBJECTS * BETA_VOLS}
    try:
        t0 = time.perf_counter()
        sex_path, expected = write_feat_tree(root / "feat", img_shape, SEED)
        out["write_s"] = time.perf_counter() - t0
        want = expected / expected.max(axis=1, keepdims=True)
        # float64: tests/test_beta_maps_cli.py's tolerance.  float32 on the
        # card: a QR solve of a (980, 7) design whose condition number is
        # ~3 keeps ~6 digits of the max-scaled maps (measured 1.8e-6 on the
        # H100, PERF.md); held at 1e-4 absolute, ~50x that reading
        tols = {"float64": (2e-3, 2e-4), "float32": (0.0, 1e-4)}
        for dtype, (rtol, atol) in tols.items():
            t0 = time.perf_counter()
            csv = beta_maps.main(["--root_dir", str(root / "feat"), "--output_dir",
                                  str(root / dtype), "--data_dims", *map(str, img_shape),
                                  str(BETA_VOLS), "--sex_covars_map", sex_path,
                                  "--solve_dtype", dtype])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            frame = pd.read_csv(csv)
            got = frame.iloc[:, 1:].to_numpy().T
            err = float(np.abs(got - want).max())
            ok = list(frame.columns[1:]) == ["task", "x", "y", "z", "xrot", "yrot",
                                             "zrot", "sex"] and \
                np.allclose(got, want, rtol=rtol, atol=atol)
            print(f"beta_maps --solve_dtype {dtype}: CLI {cli_s:.2f} s, max abs error "
                  f"{err:.3e} against the ground truth (rtol {rtol}, atol {atol})")
            if not ok:
                fail(f"beta_maps {dtype} misses the ground-truth maps")
            out[dtype] = {"cli_s": cli_s, "max_abs_err": err, "rtol": rtol, "atol": atol}
        # the solve alone, on the stacked inputs the CLI builds
        from vaegam_tpu_torch.utils import nifti
        from vaegam_tpu_torch.utils.stats import read_design_mat

        feats = sorted((root / "feat").glob("sub-*/run1_corrected.feat"))
        dms = [read_design_mat(str(f / "design.mat")) for f in feats]
        gamma = np.concatenate([np.column_stack([dm[:, 0], dm[:, -6:]]) for dm in dms])
        bold = np.concatenate([np.asarray(nifti.load(
            str(f / "filtered_func_data.nii.gz")).dataobj).reshape(-1, BETA_VOLS)
            for f in feats], axis=1)
        for dtype in tols:
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beta_maps.solve_beta_maps(gamma, bold, dtype=dtype, device="cuda")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            out[dtype]["solve_s"] = secs
            print(f"beta_maps solve alone, {dtype}: {[round(x, 4) for x in secs]} s "
                  f"({gamma.shape} design, {bold.shape[0]} voxels)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

def dp_volumes(config):
    """Phase 4c's SCAN_VOLS volumes: (vols, covs, glm)."""
    vols, covs, glm = synthetic_data(config, N_VOLS, SEED)
    more_vols, more_covs, _ = synthetic_data(config, SCAN_VOLS - N_VOLS, SEED + 1)
    return np.concatenate([vols, more_vols]), np.concatenate([covs, more_covs]), glm


def step_grads(trainer, covs, x, noise, xu=None):
    """A Trainer's loss and (summed) gradients on one batch, with the
    inducing grids `xu` when given; nothing is applied."""
    from vaegam_tpu_torch.models.vaegam import forward
    from vaegam_tpu_torch.parallel import all_reduce_grads

    consts = trainer.consts if xu is None else dict(trainer.consts, xu=xu)
    loss, _ = forward(trainer.params, consts, covs, x, trainer.config, noise=noise,
                      mesh=trainer.mesh)
    grads = torch.autograd.grad(loss, trainer._leaves)
    if trainer.mesh is not None:
        grads = all_reduce_grads(grads, trainer.mesh)
    return float(loss.detach()), grads


def float64_grads(trainer, covs, x, noise):
    """A Trainer's loss and (summed) gradients on one batch in float64 (its
    parameters cast; norm statistics in float64 too; conv5 through cuDNN),
    nothing applied."""
    from vaegam_tpu_torch.models.vaegam import forward
    from vaegam_tpu_torch.parallel import all_reduce_grads
    from vaegam_tpu_torch.utils.tree import tree_items, tree_map

    params = tree_map(lambda t: t.detach().double().requires_grad_(True), trainer.params)
    consts = {k: None if v is None else v.double() for k, v in trainer.consts.items()}
    loss, _ = forward(params, consts, covs.double(), x.double(),
                      dataclasses.replace(trainer.config, conv5_kernel=False),
                      noise=tuple(n.double() for n in noise), mesh=trainer.mesh)
    grads = torch.autograd.grad(loss, [t for _, t in tree_items(params)])
    if trainer.mesh is not None:
        grads = all_reduce_grads(grads, trainer.mesh)
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def first_step(trainer, loader):
    """The first batch of epoch 0 through a Trainer's own step, its loss
    and gradients kept; before it, nothing applied, the same batch and
    noise in float64 and in fp32 at the main path's inducing grids
    (XU_RANGES).  Returns {"fp32", "float64", "main_grid"}: (loss,
    gradients as numpy) each."""
    from vaegam_tpu_torch.models.vaegam import draw_noise

    loader.set_epoch(0)
    covs, x = loader.gather(next(loader.iter_index_batches()))
    noise = draw_noise(trainer.generator, len(covs), trainer.config, trainer.device)
    xu = torch.stack([torch.linspace(lo, hi, trainer.config.num_inducing_pts,
                                     device=trainer.device) for lo, hi in XU_RANGES])
    out = {"main_grid": step_grads(trainer, covs, x, noise, xu),
           "float64": float64_grads(trainer, covs, x, noise)}
    loss, grads = step_grads(trainer, covs, x, noise)
    trainer._apply_gradients(grads)
    out["fp32"] = loss, grads
    for k in ("fp32", "main_grid"):
        out[k] = out[k][0], [g.cpu().numpy() for g in out[k][1]]
    return out


def load_arrays(path):
    """The arrays np.savez wrote positionally, in order."""
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


def grad_shares(got, want):
    """Each gradient leaf's largest difference over its largest entry."""
    return [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            for a, b in zip(got, want)]


def _dp_step_rank(rank, coordinator, out_dir, results):
    """Phase 9a, one of DP_RANKS ranks on the one card (gloo)."""
    import vaegam_tpu_torch.ops.conv5 as conv5_mod
    from vaegam_tpu_torch._device import configure_cuda_backends
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.parallel import init_multihost, leave, replica_digests
    from vaegam_tpu_torch.train import Trainer
    from vaegam_tpu_torch.utils.tree import tree_items

    mesh = init_multihost(coordinator, DP_RANKS, rank, device="cuda:0")
    try:
        configure_cuda_backends()
        config = VAEGAMConfig()
        vols, covs, glm = dp_volumes(config)
        trainer = Trainer(config, DP_XU_RANGES, glm, seed=SEED, enable_tb=False, mesh=mesh)
        loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                                  seed=SEED, mesh=mesh)
        with Conv5Shapes(conv5_mod) as shapes:
            conv5_mod.conv5.launches = 0
            first = first_step(trainer, loader)
            full = [s for s in loader.iter_index_batches() if len(s) == BATCH]
            losses, step_ms = [first["fp32"][0]], []
            for i in range(1, DP_STEPS + DP_TIMED_STEPS):
                c, x = loader.gather(full[i % len(full)])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(trainer.train_step(c, x)[0]))
                step_ms.append(1e3 * (time.perf_counter() - t0))
            launches = conv5_mod.conv5.launches
        digests = replica_digests(trainer._leaves + trainer._mu + trainer._nu, mesh)
        for k, (_, grads) in first.items():
            np.savez(Path(out_dir) / f"{k}_{rank}.npz", *grads)
        results.put(dict(rank=rank, backend=mesh.backend, losses=losses,
                         first_losses={k: v[0] for k, v in first.items()},
                         leaves=[p for p, _ in tree_items(trainer.params)],
                         step_ms=step_ms[DP_STEPS - 1:], digests=digests,
                         conv5_launches=launches, conv5_shapes=sorted(shapes.seen)))
    finally:
        leave(mesh)


def spawn_ranks(target, args, n=DP_RANKS, timeout=900):
    """Run target(rank, *args, results) in n spawned processes; returns
    their results in rank order (each puts one dict with its "rank").  A
    rank that fails fails the run."""
    import multiprocessing

    from vaegam_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, coordinator, *args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = [], time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:  # a rank that died or hangs fails the phase
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                    fail(f"{target.__name__}: {len(out)} of {n} ranks reported; exit "
                         f"codes {codes}")
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        fail(f"{target.__name__}: ranks exited with {[p.exitcode for p in procs]}")
    return sorted(out, key=lambda r: r["rank"])


def drive_dp_share_card(config):
    """Phase 9a: DP_RANKS ranks share the card over gloo with CUDA tensors,
    on phase 4c's volumes at global batch BATCH, against a single-process
    Trainer from the same parameters and noise: their first step in
    float64 (loss DP_F64_LOSS_RTOL, each gradient leaf DP_F64_GRAD_SHARE of
    its largest entry) and in fp32 (the loss DP_LOSS_RTOL; the gradients
    printed beside both steps' distance from float64, not held to a
    bound: see DP_F64_GRAD_SHARE), DP_STEPS steps in all and the same
    parameter bytes on every rank, then DP_TIMED_STEPS timed steps.  The
    Trainers take the wide inducing grids DP_XU_RANGES; the same first
    batch at the main path's grids is printed too.  Returns (rank results,
    the phase's numbers)."""
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.train import Trainer

    vols, covs, glm = dp_volumes(config)
    single = Trainer(config, DP_XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda")
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                              seed=SEED, device="cuda")
    want = first_step(single, loader)
    del single, loader
    out_dir = Path(tempfile.mkdtemp(prefix="vaegam_dp_"))
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dp_step_rank, (str(out_dir),))
        phase_s = time.perf_counter() - t0
        got = {k: load_arrays(out_dir / f"{k}_0.npz") for k in want}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    names = ranks[0]["leaves"]
    rel = {k: abs(ranks[0]["first_losses"][k] - want[k][0]) / abs(want[k][0]) for k in want}
    f64_share = max(grad_shares(got["float64"], want["float64"][1]))
    # the fp32 steps' gradients: against each other and against float64
    vs = {"dp_vs_single": grad_shares(got["fp32"], want["fp32"][1]),
          "single_vs_f64": grad_shares(want["fp32"][1], want["float64"][1]),
          "dp_vs_f64": grad_shares(got["fp32"], want["float64"][1])}
    worst = sorted(range(len(names)), key=lambda i: -vs["dp_vs_single"][i])[:4]
    fp32_leaves = {names[i]: {k: v[i] for k, v in vs.items()} for i in worst}
    main_shares = dict(sorted(zip(names, grad_shares(got["main_grid"], want["main_grid"][1])),
                              key=lambda kv: -kv[1])[:3])
    same_bytes = all(len(set(r["digests"])) == 1 for r in ranks)
    step_ms = [statistics.median(r["step_ms"]) for r in ranks]
    print(f"DP share-card ({DP_RANKS} ranks on one card, {ranks[0]['backend']}), first step "
          f"against the single-process one: float64 loss rel {rel['float64']:.3e} (tol "
          f"{DP_F64_LOSS_RTOL}), gradients max share {f64_share:.3e} (tol "
          f"{DP_F64_GRAD_SHARE}); fp32 loss {ranks[0]['losses'][0]:.4f} vs "
          f"{want['fp32'][0]:.4f} (rel {rel['fp32']:.3e}, tol {DP_LOSS_RTOL}), gradients max "
          f"share {max(vs['dp_vs_single']):.3e}, from float64: two ranks "
          f"{max(vs['dp_vs_f64']):.3e}, single process {max(vs['single_vs_f64']):.3e}; the "
          f"leaves furthest apart {fp32_leaves}; at the main path's grids (fp32): loss rel "
          f"{rel['main_grid']:.3e}, largest shares {main_shares}; losses by rank "
          f"{[r['losses'][:DP_STEPS] for r in ranks]}; parameter and moment SHA-256 equal "
          f"on every rank {same_bytes}; step ms by rank (median of {DP_TIMED_STEPS}) "
          f"{step_ms}; conv5 launches by rank {[r['conv5_launches'] for r in ranks]}; "
          f"phase {phase_s:.1f} s")
    if ranks[0]["backend"] != "gloo":
        fail("ranks on one card must take gloo")
    if not (rel["float64"] <= DP_F64_LOSS_RTOL and f64_share <= DP_F64_GRAD_SHARE
            and rel["fp32"] <= DP_LOSS_RTOL):
        fail("the two-rank step disagrees with the single-process step")
    if not (same_bytes and all(r["losses"] == ranks[0]["losses"] for r in ranks)
            and np.isfinite(ranks[0]["losses"]).all()):
        fail("the ranks' losses or parameters differ, or a loss is not finite")
    # the first batch is forwarded twice through conv5: at both grids
    if any(r["conv5_launches"] != 1 + DP_STEPS + DP_TIMED_STEPS for r in ranks):
        fail("conv5 did not launch once per forward on every rank")
    return ranks, dict(loss_rel=rel, float64_grad_share=f64_share,
                       fp32_grad_share=max(vs["dp_vs_single"]),
                       fp32_from_float64=dict(two_ranks=max(vs["dp_vs_f64"]),
                                              single=max(vs["single_vs_f64"])),
                       fp32_leaves=fp32_leaves, main_grid_grad_shares=main_shares,
                       losses=ranks[0]["losses"], step_ms_by_rank=step_ms, phase_s=phase_s)


def drive_dp_nccl_scan(conv5_mod, config):
    """Phase 9b: a world of one over NCCL (what --data_parallel gives on a
    one-card machine) under epoch_scan, on phase 4c's volumes: under
    deterministic algorithms an eager Trainer and a replaying one train
    SCAN_EPOCHS epochs bit for bit alike; the collectives a step makes are
    captured into each width's graph; one profiled epoch each way: the NCCL
    kernel events a step runs, the same replayed as eager, and conv5's
    kernel events equal to its launches plus replays.  Returns (conv5 runs
    by path, the phase's numbers)."""
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.parallel import leave, make_data_mesh
    from vaegam_tpu_torch.parallel.mesh import counts
    from vaegam_tpu_torch.train import Trainer

    vols, covs, glm = dp_volumes(config)
    mesh = make_data_mesh("cuda")
    try:
        loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                                  seed=SEED, mesh=mesh)
        steps = -(-SCAN_VOLS // BATCH)

        def run(scan, epochs):
            t = Trainer(config, XU_RANGES, glm, seed=SEED, enable_tb=False, mesh=mesh,
                        epoch_scan=scan)
            torch.cuda.synchronize()
            conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0
            calls = counts.total()
            losses = [t.train_epoch(loader) for _ in range(epochs)]
            torch.cuda.synchronize()
            return (t, losses, conv5_mod.conv5.launches, conv5_mod.conv5.captured,
                    counts.total() - calls)

        cublas_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        try:
            eager, e_losses, e_launches, _, e_calls = run(False, SCAN_EPOCHS)
            replay, r_losses, r_launches, r_captured, r_calls = run(True, SCAN_EPOCHS)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            if cublas_env is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas_env
        (e_sha, e_mom, e_cnt), (r_sha, r_mom, r_cnt) = trainer_state(eager), \
            trainer_state(replay)
        same_moments = all(torch.equal(a, b) for a, b in zip(e_mom, r_mom))
        forwards = SCAN_EPOCHS * steps
        per_step = e_calls / forwards
        replays = sum(replay.replays.values())
        captured_calls = r_calls - (forwards - replays) * per_step
        replay_runs = r_launches + (replays if r_captured else 0)
        print(f"DP NCCL world 1, epoch_scan, deterministic: backend {mesh.backend}; losses "
              f"eager {e_losses} replay {r_losses}; params SHA-256 {e_sha[:16]} / "
              f"{r_sha[:16]}; moments equal {same_moments}; counters {e_cnt} / {r_cnt}; "
              f"captures {replay.captures}, replays {replay.replays}; collectives "
              f"{per_step:g} a step ({e_calls} eager), {captured_calls:g} recorded into "
              f"the graphs; conv5 eager {e_launches}, replay path {replay_runs}")
        if mesh.backend != "nccl":
            fail("a world of one on a card must take NCCL")
        if not (e_losses == r_losses and e_sha == r_sha and same_moments and e_cnt == r_cnt
                and np.isfinite(e_losses).all()):
            fail("the replayed DP epochs disagree with the eager ones")
        if replay.captures != {BATCH: 1, SCAN_VOLS % BATCH: 1} or replays != forwards - 2:
            fail("DP epoch_scan did not capture once a width and replay every later step")
        if per_step != int(per_step) or captured_calls != 2 * per_step:
            fail("the collectives of a step were not recorded into each width's graph")
        if e_launches != forwards or replay_runs != forwards:
            fail("conv5 did not run once a forward on the DP epoch_scan paths")
        by_path = dict(dp_nccl_eager_det=e_launches, dp_nccl_replay_det=replay_runs)
        out = dict(backend=mesh.backend, losses=e_losses, params_sha256=e_sha,
                   collectives_per_step=per_step, captures=replay.captures,
                   replays=replay.replays)
        del eager, replay

        # one profiled epoch each way, on the default backends
        for scan in (False, True):
            t = Trainer(config, XU_RANGES, glm, seed=SEED, enable_tb=False, mesh=mesh,
                        epoch_scan=scan)
            t.train_epoch(loader)                 # captures and cuDNN's search
            replays0 = sum(t.replays.values())
            conv5_mod.conv5.launches = 0
            prof = profile_epoch(t, loader)
            counted = conv5_mod.conv5.launches + sum(t.replays.values()) - replays0
            key = "replay" if scan else "eager"
            out[key] = dict(prof, conv5_counted=counted)
            print(f"DP NCCL world 1, {key} epoch: {prof['epoch_s']:.4f} s, kernels "
                  f"{prof['kernel_ms']:.2f} ms; NCCL kernel events {prof['nccl_events']}; "
                  f"conv5 kernel events {prof['conv5_events']}, counted {counted}")
            if prof["conv5_events"] != counted or counted != steps:
                fail(f"conv5's profiled kernel events do not match its runs ({key})")
            by_path[f"dp_nccl_{key}"] = counted
            del t
        if out["replay"]["nccl_events"] != out["eager"]["nccl_events"]:
            fail("a replayed DP epoch ran other NCCL kernels than an eager one")
    finally:
        leave(mesh)
    return by_path, out


def _dp_cli_rank(rank, coordinator, argv, results):
    """Phase 9c, one rank of the train CLI with --multihost on the card."""
    import vaegam_tpu_torch.ops.conv5 as conv5_mod
    from vaegam_tpu_torch.cli.train import main as cli_main

    os.environ.update(VAEGAM_COORDINATOR=coordinator, VAEGAM_NUM_PROCESSES=str(DP_RANKS),
                      VAEGAM_PROCESS_ID=str(rank))
    with Conv5Shapes(conv5_mod) as shapes:
        conv5_mod.conv5.launches = 0
        trainer, _ = cli_main(list(argv) + ["--multihost"])
        launches = conv5_mod.conv5.launches
    results.put(dict(rank=rank, train=trainer.loss["train"], test=trainer.loss["test"],
                     epoch_s=[trainer.epoch_seconds[e] for e in sorted(trainer.epoch_seconds)],
                     stats=sorted(trainer.output_stats),
                     recons=trainer.output_stats.get("recons"),
                     conv5_launches=launches, conv5_shapes=sorted(shapes.seen)))


def drive_dp_cli(study, single_losses):
    """Phase 9c: the train CLI with --multihost, DP_RANKS ranks on the card
    (gloo), on phase 5's study with phase 5's arguments for DP_CLI_EPOCHS
    epochs and then the output stage: both ranks' epoch losses equal, within
    DP_CLI_RTOL of phase 5's single-process epochs; the checkpoint, the GP
    CSVs, the recon tree and the averaged maps written once (by rank 0).
    Returns (rank results, the phase's numbers)."""
    import pandas as pd

    from vaegam_tpu_torch.utils import nifti

    design, glm, root = study
    save_dir = root / "dp"
    argv = ["--train_csv", design, "--test_csv", design, "--glm_maps", glm,
            "--save_dir", str(save_dir), "--batch-size", str(BATCH), "--seed", str(SEED),
            "--test_freq", "1", "--save_freq", "1", "--epochs", str(DP_CLI_EPOCHS)]
    t0 = time.perf_counter()
    ranks = spawn_ranks(_dp_cli_rank, (argv,))
    phase_s = time.perf_counter() - t0
    losses = [[r["train"][e] for e in range(DP_CLI_EPOCHS)] for r in ranks]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[0], single_losses))
    prefix = f"{DP_CLI_EPOCHS:03d}"
    recon = save_dir / "reconstructions" / f"{prefix}_model_recons"
    avg = save_dir / "reconstructions" / f"{prefix}_avg_model_recons"
    n_recon = sum(len(files) for _, _, files in os.walk(recon))
    n_avg = sum(len(files) for _, _, files in os.walk(avg))
    grand = sorted(avg.glob("*_avg.nii"))
    finite = all(np.isfinite(np.asarray(nifti.load(str(p)).dataobj)).all() for p in grand)
    gp_csvs = sorted((save_dir / f"{prefix}_GP_plots").glob("*.csv"))
    n_subjects = len(pd.read_csv(design).subjid.unique())
    written = {"recons", "avg_maps_s", "gp_plots_s", "umap_backend"}
    once = written <= set(ranks[0]["stats"]) and not any(
        written & set(r["stats"]) for r in ranks[1:])
    epoch_s = ranks[0]["epoch_s"]
    print(f"DP CLI ({DP_RANKS} ranks on one card): losses by rank {losses}, test "
          f"{[r['test'] for r in ranks]}; phase 5's single process {single_losses} (max rel "
          f"{rel:.3e}, tol {DP_CLI_RTOL}); epoch s by rank {[r['epoch_s'] for r in ranks]}; "
          f"files: checkpoint_001 {(save_dir / 'checkpoint_001.tar').exists()}, GP CSVs "
          f"{len(gp_csvs)}, recon maps {n_recon}, averaged maps {n_avg} (grand {len(grand)}, "
          f"finite {finite}); written by rank 0 alone {once}; conv5 launches by rank "
          f"{[r['conv5_launches'] for r in ranks]}; phase {phase_s:.1f} s")
    if not all(r["train"] == ranks[0]["train"] and r["test"] == ranks[0]["test"]
               for r in ranks):
        fail("the CLI's ranks printed different losses")
    if not rel <= DP_CLI_RTOL:
        fail("the two-rank CLI's losses miss the single-process CLI's")
    if not ((save_dir / "checkpoint_001.tar").exists() and len(gp_csvs) == 6
            and n_recon == N_STUDY * 10 and n_avg == 10 * (n_subjects + 1)
            and len(grand) == 10 and finite and once):
        fail("the two-rank CLI's outputs are missing or were not written once")
    steps = -(-N_STUDY // BATCH)
    forwards = 2 * DP_CLI_EPOCHS * steps + DP_CLI_EPOCHS + 2 * steps
    if any(r["conv5_launches"] != forwards for r in ranks):
        fail(f"conv5 did not launch once per forward on every rank ({forwards})")
    shutil.rmtree(save_dir, ignore_errors=True)
    return ranks, dict(losses=losses[0], test=ranks[0]["test"], single_losses=single_losses,
                       max_rel=rel, epoch_s=epoch_s, steady_epoch_s=epoch_s[-1],
                       recons=ranks[0]["recons"], phase_s=phase_s)


def drive_data_parallel(conv5_mod, study, single_losses):
    """Phases 9a-9c; returns (conv5 runs by path, the launch shapes the
    ranks saw, the phases' numbers)."""
    from vaegam_tpu_torch.models import VAEGAMConfig

    config = VAEGAMConfig()
    share, numbers = {}, {}
    share_ranks, numbers["share_card"] = drive_dp_share_card(config)
    by_path, numbers["nccl_world1_scan"] = drive_dp_nccl_scan(conv5_mod, config)
    cli_ranks, numbers["cli"] = drive_dp_cli(study, single_losses)
    shapes = set()
    for tag, ranks in (("dp_share_card", share_ranks), ("dp_cli", cli_ranks)):
        for r in ranks:
            by_path[f"{tag}_rank{r['rank']}"] = r["conv5_launches"]
            shapes |= {tuple(s) for s in r["conv5_shapes"]}
    return by_path, shapes, numbers



# ---------------------------------------------------------------------------
# phase 10: conv_pack on the card, and the study tools
# ---------------------------------------------------------------------------

PACKS = ((2, 2), (4, 4))
PACK_AB_STEPS, PACK_SCAN_EPOCHS, PACK_BF16_EPOCHS = 20, 3, 2
# the bounds of the JAX package's test_model_stacks_invariant_under_conv_pack
# (tests/test_ops.py:157-205, 21x25x21 at B=4): outputs, then gradients,
# (rtol, atol).  At full width the gradient leaves are sums over ~2e7 map
# elements (|g| up to ~1e5), and the unpacked fp32 decoder's own gradients
# sit ~500x those bounds from its float64 ones, so 10a.1 holds packed
# against unpacked at them in float64 and in the fp32 outputs.  The fp32
# gradients of each arm are held to the same float64 ones, as each leaf's
# largest difference over its largest entry: the packed arm's at most
# FP32_GRAD_SHARE on every leaf and its stack's worst at most
# FP32_GRAD_VS_UNPACKED times the unpacked arm's worst (both arms read
# about 2e-4 of the leaf on the H100 at B=32, PERF.md)
PACK_OUT_TOL, PACK_GRAD_TOL = (1e-4, 1e-5), (1e-3, 2e-3)
FP32_GRAD_SHARE, FP32_GRAD_VS_UNPACKED = 1e-3, 3.0
# the packed bf16 recipe against the unpacked one: the first step's loss
# (rtol) and the maps (relative L2, the port's bf16 map bound)
PACK_BF16_LOSS_RTOL, PACK_BF16_MAP_RL2 = 1e-3, 1e-2
TOOL_ITERS, MNI_BATCH = 10, 8        # bench_packed_conv's timed calls; the MNI tools' batch
MNI_DP_RANKS = 2                     # mni_mesh_dryrun's ranks on the one card


def excess(a, b, tol):
    """max |a - b| / (atol + rtol |b|): at most 1 where assert_allclose passes."""
    rtol, atol = tol
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def reset_conv5(conv5_mod):
    torch.cuda.synchronize()
    conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0


def free_card():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def pack_stacks(params, x, z, config, pack, dtype=torch.float32):
    """The JAX test's stack losses at full width in `dtype` (float64 with
    conv5 on cuDNN), {"enc", "dec"}: (the stack's output, its gradients
    leaf by leaf)."""
    from vaegam_tpu_torch.models.networks import decode, encode
    from vaegam_tpu_torch.utils.tree import tree_items, tree_map

    out = {}
    for which in ("enc", "dec"):
        prm = tree_map(lambda t: t.detach().to(dtype, copy=True).requires_grad_(True),
                       params[which])
        if which == "enc":
            mu, u, d = encode(prm, x.to(dtype), config.conv5_kernel and dtype == torch.float32,
                              conv_pack=pack)
            loss, o = (torch.sin(mu) + torch.cos(u) + d).sum(), mu
        else:
            o = decode(prm, z.to(dtype), config.img_shape, config.num_covariates + 1,
                       conv_pack=pack)
            loss = torch.sin(o * 3.0).sum()
        leaves = tree_items(prm)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[which] = o.detach(), dict(zip([p for p, _ in leaves], grads))
    return out


def fp32_grad_shares(got, want):
    """{leaf: its largest |fp32 - float64| over its largest float64 entry}."""
    return {k: float((got[k].double() - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for k, b in want.items()}


def drive_pack_stacks(conv5_mod, config):
    """10a.1: encode at B=32 and the 288-row decode with each pack against
    the unpacked stacks, the same parameters: in float64 outputs and
    gradients, in fp32 the outputs, at the JAX test's bounds; the packed
    fp32 gradients against float64 at FP32_GRAD_SHARE of each leaf and
    within FP32_GRAD_VS_UNPACKED of the unpacked arm's.  Returns (conv5
    launches, the numbers)."""
    from vaegam_tpu_torch.models import init_model

    params, _ = init_model(config, XU_RANGES, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((BATCH,) + config.img_shape, generator=gen, device="cuda")
    z = torch.randn(((config.num_covariates + 1) * BATCH, config.z_dim), generator=gen,
                    device="cuda")
    reset_conv5(conv5_mod)
    ref = pack_stacks(params, x, z, config, None)
    ref64 = pack_stacks(params, x, z, config, None, torch.float64)
    plain = {w: fp32_grad_shares(ref[w][1], ref64[w][1]) for w in ("enc", "dec")}
    out = {"unpacked_fp32_from_f64": {w: max(v.values()) for w, v in plain.items()}}
    for pack in PACKS:
        got = pack_stacks(params, x, z, config, pack)
        got64 = pack_stacks(params, x, z, config, pack, torch.float64)
        row, ratio = {}, {}
        for w in ("enc", "dec"):
            (o, g), (o0, _) = got[w], ref[w]
            (o64, g64), (o064, g064) = got64[w], ref64[w]
            shares = fp32_grad_shares(g, g064)
            worst = max(shares, key=shares.get)
            ratio[w] = shares[worst] / max(max(plain[w].values()), 1e-30)
            row[w] = dict(out=excess(o, o0, PACK_OUT_TOL),
                          out_f64=excess(o64, o064, PACK_OUT_TOL),
                          grads_f64=max(excess(g64[k], g064[k], PACK_GRAD_TOL) for k in g064),
                          grads_fp32_from_f64=shares[worst], worst_leaf=worst,
                          unpacked_on_that_leaf=plain[w][worst],
                          over_unpacked_worst=ratio[w])
        out[f"{pack[0]}x{pack[1]}"] = row
        print(f"conv_pack {pack} stacks against unpacked (B={BATCH}, decode {o.shape[0]} "
              f"rows), worst |a-b|/(atol+rtol|b|) at {PACK_OUT_TOL} / {PACK_GRAD_TOL} "
              f"(pass <= 1): fp32 outputs enc {row['enc']['out']:.3g} dec "
              f"{row['dec']['out']:.3g}; float64 outputs {row['enc']['out_f64']:.3g} / "
              f"{row['dec']['out_f64']:.3g}, gradients {row['enc']['grads_f64']:.3g} / "
              f"{row['dec']['grads_f64']:.3g}; fp32 gradients from float64, the worst "
              f"leaf's largest difference over its largest entry (bound {FP32_GRAD_SHARE}): "
              f"packed enc {row['enc']['grads_fp32_from_f64']:.3g} "
              f"({row['enc']['worst_leaf']}) dec {row['dec']['grads_fp32_from_f64']:.3g} "
              f"({row['dec']['worst_leaf']}), unpacked {out['unpacked_fp32_from_f64']['enc']:.3g}"
              f" / {out['unpacked_fp32_from_f64']['dec']:.3g}; packed over unpacked "
              f"{ratio['enc']:.3g} / {ratio['dec']:.3g} (bound {FP32_GRAD_VS_UNPACKED})")
        if max(r[k] for r in row.values() for k in ("out", "out_f64", "grads_f64")) > 1:
            fail(f"the packed stacks ({pack}) disagree with the unpacked ones")
        if max(r["grads_fp32_from_f64"] for r in row.values()) > FP32_GRAD_SHARE or \
                max(ratio.values()) > FP32_GRAD_VS_UNPACKED:
            fail(f"the packed fp32 gradients ({pack}) are further from float64 than the "
                 "bound or than the unpacked arm's")
    launches = conv5_mod.conv5.launches
    if launches != 1 + len(PACKS):
        fail(f"conv5 launched {launches} times for {1 + len(PACKS)} fp32 encoder forwards")
    return launches, out


def drive_pack_float64():
    """10a.2: one float64 step (conv5 off), each pack against unpacked, the
    same weights, batch and noise; returns the numbers."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.models.vaegam import draw_noise
    from vaegam_tpu_torch.train import Trainer
    from vaegam_tpu_torch.utils.tree import tree_items

    config = VAEGAMConfig(dtype=torch.float64, conv5_kernel=False)
    vols, covs, glm = synthetic_data(config, BATCH, SEED)
    batch = {"covariates": covs, "volume": vols}
    noise = draw_noise(torch.Generator().manual_seed(SEED), BATCH, config, "cpu")
    runs = {}
    for pack in (None,) + PACKS:
        t = Trainer(dataclasses.replace(config, conv_pack=pack), XU_RANGES, glm, seed=SEED,
                    enable_tb=False, device="cuda")
        loss, _ = t.train_step(*t._put_batch(batch), noise=tuple(n.cuda() for n in noise))
        runs[pack] = float(loss), [m.cpu().numpy() for _, m in tree_items(t.opt_state["mu"])]
        del t
    loss0, mu0 = runs[None]
    out = {}
    for pack in PACKS:
        loss, mu = runs[pack]
        rel = abs(loss - loss0) / abs(loss0)
        share = max(grad_shares(mu, mu0))
        out[f"{pack[0]}x{pack[1]}"] = dict(loss=loss, loss_rel=rel, grad_share=share)
        print(f"conv_pack {pack} float64 step (B={BATCH}): loss {loss!r} against {loss0!r} "
              f"(rel {rel:.3e}, bound {DP_F64_LOSS_RTOL}); gradients (the first Adam "
              f"moment) {share:.3e} of each leaf's largest (bound {DP_F64_GRAD_SHARE})")
        if not (np.isfinite(loss) and rel <= DP_F64_LOSS_RTOL and share <= DP_F64_GRAD_SHARE):
            fail(f"the packed float64 step ({pack}) disagrees with the unpacked one")
    out["loss_unpacked"] = loss0
    return out


def drive_pack_training(conv5_mod, config):
    """10a.3: on phase 4c's volumes, for each pack: a packed Trainer's eager
    epoch, PACK_AB_STEPS steps timed in turns with an unpacked Trainer's,
    and PACK_SCAN_EPOCHS epochs under epoch_scan (and the unpacked
    replayed epochs once, for their time).  Returns (conv5 runs by path,
    the numbers)."""
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.tools.common import graph_pool_mib
    from vaegam_tpu_torch.train import Trainer

    vols, covs, glm = dp_volumes(config)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                              seed=SEED, device="cuda")
    steps = -(-SCAN_VOLS // BATCH)
    full = [s for s in loader.iter_index_batches() if len(s) == BATCH]
    by_path, out = {}, {}

    def scan(cfg, tag):
        t = Trainer(cfg, XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda",
                    epoch_scan=True)
        reset_conv5(conv5_mod)
        losses = [t.train_epoch(loader) for _ in range(PACK_SCAN_EPOCHS)]
        torch.cuda.synchronize()
        runs = conv5_mod.conv5.launches + sum(t.replays.values())
        secs = [t.epoch_seconds[e] for e in range(PACK_SCAN_EPOCHS)]
        print(f"conv_pack {tag} epoch_scan: losses {losses}, epochs "
              f"{[round(s, 4) for s in secs]} s; captures {t.captures}, replays "
              f"{t.replays}; conv5 {conv5_mod.conv5.launches} launches + "
              f"{conv5_mod.conv5.captured} captured -> {runs} runs for "
              f"{PACK_SCAN_EPOCHS * steps} forwards; graph pool {graph_pool_mib()} MiB")
        if not np.isfinite(losses).all():
            fail(f"non-finite replayed losses ({tag})")
        if t.captures != {BATCH: 1, SCAN_VOLS % BATCH: 1} or \
                conv5_mod.conv5.captured != 2 or runs != PACK_SCAN_EPOCHS * steps:
            fail(f"epoch_scan ({tag}) did not capture once a width or conv5 did not run "
                 "once a forward")
        return runs, dict(losses=losses, epoch_s=secs, steady_epoch_s=statistics.median(secs[1:]),
                          captures=t.captures, replays=t.replays)

    by_path["pack_scan_unpacked"], out["scan_unpacked"] = scan(config, "off")
    free_card()
    for pack in PACKS:
        tag = f"{pack[0]}x{pack[1]}"
        cfg = dataclasses.replace(config, conv_pack=pack)
        t = Trainer(cfg, XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda")
        plain = Trainer(config, XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda")
        # conv5's launches by trainer: the packed epoch and A/B steps, the
        # unpacked search step and A/B steps
        launches = {"packed": 0, "unpacked": 0}

        def counted(name, fn, *a):
            n0 = conv5_mod.conv5.launches
            r = fn(*a)
            torch.cuda.synchronize()
            launches[name] += conv5_mod.conv5.launches - n0
            return r

        reset_conv5(conv5_mod)
        loss = counted("packed", t.train_epoch, loader)
        # cuDNN's search for the plain B=32
        counted("unpacked", plain.train_step, *loader.gather(full[0]))
        ms = {"packed": [], "unpacked": []}
        for i in range(PACK_AB_STEPS):
            for name, tr in (("packed", t), ("unpacked", plain)):
                c, x = loader.gather(full[i % len(full)])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counted(name, tr.train_step, c, x)
                ms[name].append(1e3 * (time.perf_counter() - t0))
        eager_epoch_s = t.epoch_seconds[0]
        forwards = {"packed": steps + PACK_AB_STEPS, "unpacked": 1 + PACK_AB_STEPS}
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"conv_pack {pack} eager: epoch loss {loss:.4f} in {t.epoch_seconds[0]:.2f} s; "
              f"{PACK_AB_STEPS} steps in turns, median ms packed {med['packed']:.2f} "
              f"unpacked {med['unpacked']:.2f} (packed/unpacked "
              f"{med['packed'] / med['unpacked']:.3f}); conv5 launches {launches} for "
              f"forwards {forwards}")
        if not np.isfinite(loss) or launches != forwards:
            fail(f"the packed eager epoch ({pack}) is not finite or conv5 did not run once "
                 "a forward")
        by_path[f"pack_{tag}_eager"] = launches["packed"]
        by_path[f"pack_{tag}_ab_unpacked"] = launches["unpacked"]
        del t, plain
        free_card()
        by_path[f"pack_{tag}_scan"], scan_out = scan(cfg, tag)
        out[tag] = dict(epoch_loss=loss, eager_epoch_s=eager_epoch_s, step_ms=ms,
                        step_ms_median=med, packed_over_unpacked=med["packed"] / med["unpacked"],
                        scan=scan_out)
        free_card()
    return by_path, out


def drive_pack_bf16(conv5_mod, config):
    """10a.4: the bf16 recipe (bf16 convs, joint norm statistics) packed
    (2, 2) against unpacked from one seed: the first step's loss and a
    deterministic maps forward, then PACK_BF16_EPOCHS eager epochs each;
    conv5 must not launch.  Returns the numbers."""
    from vaegam_tpu_torch.data import DeviceResidentLoader
    from vaegam_tpu_torch.models import forward
    from vaegam_tpu_torch.models.vaegam import draw_noise
    from vaegam_tpu_torch.train import Trainer

    vols, covs, glm = dp_volumes(config)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                              seed=SEED, device="cuda")
    bf16 = dataclasses.replace(config, conv_dtype=torch.bfloat16, fused_norm_stats=True)
    cfgs = {"packed": dataclasses.replace(bf16, conv_pack=(2, 2)), "unpacked": bf16}
    trainers = {k: Trainer(c, XU_RANGES, glm, seed=SEED, enable_tb=False, device="cuda")
                for k, c in cfgs.items()}
    c, x = loader.gather(next(loader.iter_index_batches()))
    noise = draw_noise(torch.Generator(device="cuda").manual_seed(SEED), BATCH, config,
                       "cuda")
    reset_conv5(conv5_mod)
    maps, first = {}, {}
    for k, t in trainers.items():
        with torch.no_grad():
            _, aux = forward(t.params, t.consts, c, x, t.config, deterministic=True,
                             return_maps=True)
        maps[k] = aux["maps"]
        first[k] = float(t.train_step(c, x, noise=noise)[0])
    rl2 = max(float((maps["packed"][m] - maps["unpacked"][m]).norm()
                    / maps["unpacked"][m].norm()) for m in maps["unpacked"])
    rel = abs(first["packed"] - first["unpacked"]) / abs(first["unpacked"])
    epochs = {k: [t.train_epoch(loader) for _ in range(PACK_BF16_EPOCHS)]
              for k, t in trainers.items()}
    secs = {k: [t.epoch_seconds[e] for e in range(PACK_BF16_EPOCHS)]
            for k, t in trainers.items()}
    launches = conv5_mod.conv5.launches
    print(f"conv_pack (2, 2) bf16 recipe: first-step loss {first['packed']!r} against "
          f"{first['unpacked']!r} (rel {rel:.3e}, bound {PACK_BF16_LOSS_RTOL}); maps "
          f"relative L2 {rl2:.3e} (bound {PACK_BF16_MAP_RL2}); epochs {epochs}, seconds "
          f"{secs}; conv5 launches {launches}")
    if not (rel <= PACK_BF16_LOSS_RTOL and rl2 <= PACK_BF16_MAP_RL2
            and np.isfinite(epochs["packed"]).all()):
        fail("the packed bf16 recipe disagrees with the unpacked one or is not finite")
    if launches:
        fail("conv5 launched on the bf16 recipe")
    return dict(first_step_loss=first, loss_rel=rel, maps_rel_l2=rl2, epoch_losses=epochs,
                epoch_s=secs)


def run_tool(conv5_mod, module, argv, what):
    """A study tool's main(argv) in this process, conv5's counters reset
    first; returns (its result, conv5 launches)."""
    free_card()
    reset_conv5(conv5_mod)
    t0 = time.perf_counter()
    result = module.main(argv)
    torch.cuda.synchronize()
    print(f"{what}: {time.perf_counter() - t0:.1f} s", flush=True)
    return result, conv5_mod.conv5.launches


def drive_phase10(conv5_mod, lap):
    """Phase 10: conv_pack on the card (10a) and the study tools (10b-10f);
    `lap` closes each sub-phase's seconds.  Returns (conv5 runs by path,
    the numbers, the conv5 launch shapes of mni_mesh_dryrun's ranks)."""
    from vaegam_tpu_torch.models import VAEGAMConfig
    from vaegam_tpu_torch.tools import (bench_mni_prefetch, bench_packed_conv, bench_recon,
                                        beta_solve_precision_study, conv5_fullstep_study,
                                        epoch_scan_diagnosis, epsilon_precision_study,
                                        mni_mesh_dryrun)

    config = VAEGAMConfig()
    by_path, out = {}, {}
    by_path["pack_stacks"], out["stacks"] = drive_pack_stacks(conv5_mod, config)
    free_card()
    out["float64"] = drive_pack_float64()
    free_card()
    lap("10a_pack_checks")
    paths, out["train"] = drive_pack_training(conv5_mod, config)
    by_path.update(paths)
    out["bf16"] = drive_pack_bf16(conv5_mod, config)
    lap("10a_pack_training")

    # 10b. the per-layer bench, at the packs 10a trains
    out["bench_packed_conv"], launches = run_tool(
        conv5_mod, bench_packed_conv,
        ["--iters", str(TOOL_ITERS), "--packs", *(f"{a}x{b}" for a, b in PACKS)],
        "10b bench_packed_conv")
    if launches:
        fail("conv5 launched in bench_packed_conv")
    lap("10b_bench_packed_conv")

    # 10c. conv5's share of the full step, eager and replayed
    rounds, iters = 2, 20
    res, launches = run_tool(conv5_mod, conv5_fullstep_study,
                             ["--rounds", str(rounds), "--iters", str(iters)],
                             "10c conv5_fullstep_study")
    runs = launches + sum(res["replays"]["kernel"].values())
    if runs != 2 * (1 + rounds) * iters:
        fail(f"conv5 ran {runs} times for {2 * (1 + rounds) * iters} kernel-arm forwards")
    by_path["conv5_fullstep"], out["conv5_fullstep"] = runs, res
    lap("10c_conv5_fullstep")

    # 10d. the eval-width sweep: 1 subject x 98 volumes at widths 32 and 128
    res, launches = run_tool(conv5_mod, bench_recon,
                             ["--n_subjs", "1", "--n_vols", str(ORACLE_VOLS),
                              "--widths", str(BATCH), str(WIDE_EVAL_BATCH)],
                             "10d bench_recon")
    forwards = sum(4 * -(-ORACLE_VOLS // int(w)) for w in res["widths"])
    if launches != forwards:
        fail(f"conv5 launched {launches} times in bench_recon for {forwards} forwards")
    by_path["bench_recon"], out["bench_recon"] = launches, res
    lap("10d_bench_recon")

    # 10e. the precision studies
    eps_steps = 20
    res, launches = run_tool(conv5_mod, epsilon_precision_study,
                             ["--steps", str(eps_steps)], "10e epsilon_precision_study")
    if launches != 2 * eps_steps:
        fail(f"conv5 launched {launches} times in the epsilon study for {2 * eps_steps} steps")
    by_path["epsilon_study"], out["epsilon_study"] = launches, res
    out["beta_solve_study"], _ = run_tool(conv5_mod, beta_solve_precision_study,
                                          ["--n_subj", str(STUDY_SUBJECTS)],
                                          "10e beta_solve_precision_study")
    lap("10e_precision_studies")

    # 10f. the MNI grid: the host loaders, replayed epochs, then data
    # parallel over ranks that share the card
    mni_loaders, mni_epochs = ("data", "prefetch"), 1
    res, launches = run_tool(conv5_mod, bench_mni_prefetch,
                             ["--n_subjs", "2", "--n_vols", "49", "--batch", str(MNI_BATCH),
                              "--epochs", str(mni_epochs), "--loaders", *mni_loaders],
                             "10f bench_mni_prefetch")
    forwards = len(mni_loaders) * (1 + mni_epochs) * -(-98 // MNI_BATCH)
    if launches != forwards:
        fail(f"conv5 launched {launches} times in bench_mni_prefetch for {forwards} forwards")
    by_path["mni_prefetch"], out["mni_prefetch"] = launches, res
    diag_epochs, probe_every = 4, 3
    res, launches = run_tool(conv5_mod, epoch_scan_diagnosis,
                             ["--epochs", str(diag_epochs), "--probe_every", str(probe_every),
                              "--batch_size", str(MNI_BATCH)], "10f epoch_scan_diagnosis")
    runs = launches + sum(res["replays"].values())
    probes = sum(1 for e in range(diag_epochs) if e % probe_every == 0 or e < 3)
    forwards = diag_epochs * -(-98 // MNI_BATCH) + 2 * probes
    if runs != forwards or res["captures"] != {MNI_BATCH: 1, 98 % MNI_BATCH: 1}:
        fail(f"epoch_scan_diagnosis: conv5 ran {runs} times for {forwards} forwards, "
             f"captures {res['captures']}")
    by_path["epoch_scan_diagnosis"] = runs
    out["epoch_scan_diagnosis"] = {k: v for k, v in res.items() if k != "records"}
    out["epoch_scan_diagnosis"]["epochs"] = [r for r in res["records"] if "epoch" in r]
    res, _ = run_tool(conv5_mod, mni_mesh_dryrun, ["--n_ranks", str(MNI_DP_RANKS)],
                      "10f mni_mesh_dryrun")
    launches = [r["conv5_launches"] for r in res["ranks"]]
    if res["backend"] != "gloo" or not all(r["device"].startswith("cuda")
                                           for r in res["ranks"]):
        fail(f"mni_mesh_dryrun's ranks did not share the card over gloo: {res['ranks']}")
    if launches != [res["steps"]] * MNI_DP_RANKS:
        fail(f"conv5 launched {launches} times on mni_mesh_dryrun's ranks for "
             f"{res['steps']} forwards each")
    by_path["mni_mesh_dryrun_ranks"], out["mni_mesh_dryrun"] = sum(launches), res
    rank_shapes = {(res["batch_rows"], *CONV5_SHAPES["mni"][1:])}
    lap("10f_mni")
    return by_path, out, rank_shapes


# ---------------------------------------------------------------------------
# phase 11: the TPU's product arithmetic (VAEGAMConfig(tpu_products=True))
# ---------------------------------------------------------------------------

# the oracle's config (control_experiment at its defaults) in the arm
TPU_ORACLE_KW = dict(glm_reg_scale=1.0, neural_covariates=False, qu_s_cholesky=True,
                     fused_norm_stats=True)
# products by kind in one step of the oracle's config, as
# tests/test_torch_port_tpu_products.py pins them against JAX's jaxpr
TPU_ORACLE_SITES = {"forward": 29, "input_grad": 29, "weight_grad": 27}
# 11b: the arm's fp32 step against its float64 step (same weights, noise
# and rounding sites): loss rtol; each gradient leaf's distance as a share
# of its largest entry, held to the bound of the first group of
# TPU_GRAD_GROUPS with a prefix of the leaf's name (about 3x the group's
# worst reading on an H100); the same bounds hold the arm's step again and
# a witness, the arm's step on cuDNN's deterministic algorithms (other
# summation orders of the same rounded products).  The fp32 step without
# the arm must sit at least TPU_LIVE_RATIO times further from the arm's
# fp32 loss than float64 does, and beyond its bound on each leaf of
# TPU_LIVE_LEAVES, so that a step with no rounding fails the check.
# Read on an H100: loss 7.48e-7; the encoder's leaves 2e-3..0.36
# (enc/bn1/scale), the decoder's 5e-4..0.045, the GP's scales and epsilon
# 2e-3..0.087, the output layer and the gain bank 7e-7..1.5e-4 (without the
# arm: 4e-6..6.5e-3).  The fp32 and float64 sums part by ~1e-7, which moves
# the bfloat16 rounding of values near a rounding boundary, and the
# encoder's gradients, sums that cancel over the volume, amplify the flips:
# another summation order alone (the witness; or the same step again,
# cuDNN's atomics) moves enc/bn1/scale by 0.04..0.1 in the arm, while
# without the arm fp32 sits ~1e-4 of a leaf from float64 (phase 10a).  The
# float64 CPU test (tests/test_torch_port_tpu_products.py) holds the arm's
# gradients to JAX's at 1e-7.
TPU_LOSS_RTOL, TPU_LIVE_RATIO = 1e-6, 10.0
TPU_GRAD_GROUPS = (  # (group, leaf-name prefixes, bound)
    ("output layer", ("dec/convt5/", "dec/bnt5/"), 5e-4),
    ("gain bank", ("gp/qu_m", "gp/sa", "gp/logstd"), 4e-4),
    ("decoder", ("dec/",), 0.15),
    ("GP scales, epsilon", ("gp/", "epsilon"), 0.3),
    ("encoder", ("enc/",), 1.1),
)
# the weights of the output layer and of the gain bank's mean and scale;
# not convt5's bias (its gradient is the cotangent's unrounded sum) nor
# logstd (it reads the rounded forward only through the residuals)
TPU_LIVE_LEAVES = ("dec/convt5/w", "dec/bnt5/scale", "dec/bnt5/shift", "gp/qu_m", "gp/sa")
TPU_TIMED_SHAPES = ("main", "mni")


def hmma_by_function(lib) -> dict:
    """HMMA instructions of each kernel function in a built library
    (cuobjdump --dump-sass), by mangled name."""
    from vaegam_tpu_torch.ops.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def one_pass_bounds(shape):
    """(bound_ms, bound_by): one TF32 tensor-core pass over the conv's
    products against the bytes floor."""
    bsz, ci, d, h, wd, co = shape
    n_out = bsz * co * (d - 2) * (h - 2) * (wd - 2)
    tc_s = 2.0 * n_out * 27 * ci / TF32_FLOPS
    bytes_s = 4.0 * (bsz * ci * d * h * wd + co * ci * 27 + co + n_out) / HBM_BYTES_PER_S
    return 1e3 * max(tc_s, bytes_s), "operations" if tc_s >= bytes_s else "bytes"


def check_conv5_one_pass(conv5_mod, lib, names):
    """11a: conv5's one-pass path against its plain version (``F.conv3d`` on
    bfloat16-rounded operands, TF32 off) at `names` of CONV5_SHAPES, forward
    and backward; device times (``graph_ms``) of the path, the split path,
    the plain version and ``F.conv3d`` at TPU_TIMED_SHAPES; its HMMA count.  Returns the numbers."""
    import torch.nn.functional as F
    from vaegam_tpu_torch.ops.products import round_bf16

    hmma = hmma_by_function(lib)
    one = {k: v for k, v in hmma.items() if "ILb1E" in k}
    split = {k: v for k, v in hmma.items() if "ILb0E" in k}
    print(f"HMMA instructions by kernel path: one-pass {sorted(one.values())}, split "
          f"{sorted(split.values())}")
    if len(one) != 1 or len(split) != 1 or not 0 < sum(one.values()) < sum(split.values()):
        fail(f"conv5's one-pass path has no tensor-core instruction of its own: {hmma}")
    out = {"hmma_one_pass": sum(one.values()), "hmma_split": sum(split.values())}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    errs = {}
    for name in names:
        shape = CONV5_SHAPES[name]
        x, w, b = conv5_inputs(shape, gen)
        got = conv5_mod.conv5_cuda(x, w, b, one_pass=True)
        xr, wr = round_bf16(x), round_bf16(w)
        want = F.conv3d(xr, wr, b)
        full = F.conv3d(x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        live = float((full - want).abs().max())
        # the backward rounds the cotangent and the saved operands; the
        # bias gradient is the unrounded cotangent's sum
        xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        g = torch.randn(want.shape, generator=gen, device="cuda")
        gk = torch.autograd.grad(conv5_mod.conv5(*xs, one_pass=True), xs, g)
        xp = [t.clone().requires_grad_(True) for t in (xr, wr)]
        gp = (*torch.autograd.grad(F.conv3d(*xp), xp, round_bf16(g)), g.sum(dim=(0, 2, 3, 4)))
        gerr = max(float((a - c).abs().max() / max(1.0, float(c.abs().max())))
                   for a, c in zip(gk, gp))
        print(f"conv5 one-pass {name} {tuple(x.shape)}: max_abs_err {err:.3e} against "
              f"F.conv3d on rounded operands (tol {tol:.1e}); {live:.3e} from the full "
              f"float32 conv; grads max scaled err {gerr:.3e} (tol 2e-4)")
        if not err <= tol:
            fail(f"conv5's one-pass path disagrees with its plain version at {name}")
        if not live > 10 * tol:
            fail(f"conv5's one-pass check at {name} cannot tell rounded from full float32")
        if not gerr <= 2e-4:
            fail(f"conv5's one-pass gradients disagree at {name}")
        errs[name] = err
        if name not in TPU_TIMED_SHAPES:
            continue
        prefix = "" if name == "main" else f"{name}_"
        fns = {"ms": lambda: conv5_mod.conv5_cuda(x, w, b, one_pass=True),
               "split_ms": lambda: conv5_mod.conv5_cuda(x, w, b),
               "library_ms": lambda: F.conv3d(xr, wr, b)}
        if name == "main":
            fns["plain_ms"] = lambda: conv5_mod.conv5_plain_bf16(x, w, b)
        for key, fn in fns.items():
            ms = graph_ms(fn)
            if not ms > 0:
                fail(f"no device time for conv5 one-pass {name} {key}")
            out[prefix + key] = ms
        out[prefix + "bound_ms"], by = one_pass_bounds(shape)
        if name == "main":
            out["bound_by"] = by
        print(f"conv5 one-pass {name}: {out[prefix + 'ms']:.5f} ms a call (CUDA events "
              f"around graph replays); split path {out[prefix + 'split_ms']:.5f}; F.conv3d on "
              f"rounded operands {out[prefix + 'library_ms']:.5f}"
              + (f"; plain {out['plain_ms']:.5f}" if name == "main" else "")
              + f"; bound {out[prefix + 'bound_ms']:.5f} ms (one TF32 pass)")
    out["max_abs_err"] = errs.get("main", max(errs.values()))
    out["max_abs_err_by_shape"] = errs
    return out


def tpu_step(config, params, consts, covs, x, noise, dtype):
    """One forward and backward of `config` in `dtype` from `params`: (loss,
    gradients by leaf, product sites by kind)."""
    from vaegam_tpu_torch.models.vaegam import forward
    from vaegam_tpu_torch.ops import products
    from vaegam_tpu_torch.utils.tree import tree_items, tree_map

    prm = tree_map(lambda t: t.detach().to(dtype).requires_grad_(True), params)
    cst = {k: None if v is None else v.to(dtype) for k, v in consts.items()}
    products.reset_sites()
    loss, _ = forward(prm, cst, covs.to(dtype), x.to(dtype), config,
                      noise=tuple(n.to(dtype) for n in noise))
    leaves = tree_items(prm)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    torch.cuda.synchronize()
    return (float(loss.detach()), {p: g.double() for (p, _), g in zip(leaves, grads)},
            products.site_counts())


def drive_tpu_step(conv5_mod):
    """11b: one full-width step of the oracle's config in the arm (fp32,
    conv5 on its one-pass path) against the same step in float64 in the
    arm (conv5 through products.conv3d), same weights, noise and rounding
    sites, on the wide inducing grids; the fp32 step without the arm beside
    them.  Returns the numbers."""
    from vaegam_tpu_torch.models import VAEGAMConfig, init_model
    from vaegam_tpu_torch.models.vaegam import draw_noise

    arm = VAEGAMConfig(tpu_products=True, **TPU_ORACLE_KW)
    arm64 = dataclasses.replace(arm, conv5_kernel=False)
    vols, covs, glm = synthetic_data(arm, BATCH, SEED + 11)
    params, consts = init_model(arm, DP_XU_RANGES, glm, seed=SEED, device="cuda")
    covs, x = torch.tensor(covs, device="cuda"), torch.tensor(vols, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    noise = draw_noise(gen, BATCH, arm, "cuda")
    reset_conv5(conv5_mod)
    t0 = time.perf_counter()
    l32, g32, sites32 = tpu_step(arm, params, consts, covs, x, noise, torch.float32)
    step_s = time.perf_counter() - t0
    launches = conv5_mod.conv5.launches
    l64, g64, sites64 = tpu_step(arm64, params, consts, covs, x, noise, torch.float64)
    off = dataclasses.replace(arm, tpu_products=False)
    plain, g_off, sites_off = tpu_step(off, params, consts, covs, x, noise, torch.float32)
    _, g_off_again, _ = tpu_step(off, params, consts, covs, x, noise, torch.float32)
    _, g_again, _ = tpu_step(arm, params, consts, covs, x, noise, torch.float32)
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        _, g_wit, _ = tpu_step(arm, params, consts, covs, x, noise, torch.float32)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved

    def share(g, ref=g64):
        return {p: float((g[p] - ref[p]).abs().max() / g64[p].abs().max().clamp_min(1e-300))
                for p in g64}

    def group(leaf):
        return next(name for name, pre, _ in TPU_GRAD_GROUPS if leaf.startswith(pre))

    bounds = {name: b for name, _, b in TPU_GRAD_GROUPS}

    def bound(leaf):
        return bounds[group(leaf)]

    shares, off_shares = share(g32), share(g_off)
    again, wit, wit_arm = share(g_again), share(g_wit), share(g_wit, g32)
    # the same step twice: how far a summation order moves the gradient
    # with the rounding and without it
    order = {"arm": max(share(g_again, g32).values()),
             "no_arm": max(share(g_off_again, g_off).values())}
    worst = max(shares, key=lambda p: shares[p] / bound(p))
    print("11b gradient leaves, distance from the float64 arm as a share of the leaf's largest "
          "entry: the fp32 arm / again / on deterministic algorithms (the witness) / the "
          "fp32 step without the arm; the witness's distance from the arm; bound:\n"
          + "\n".join(f"  {p}: {shares[p]:.3e} / {again[p]:.3e} / {wit[p]:.3e} / "
                      f"{off_shares[p]:.3e}; {wit_arm[p]:.3e}; {bound(p):g}"
                      for p in sorted(shares, key=shares.get, reverse=True)))
    by_group = {name: max(v for p, v in shares.items() if group(p) == name)
                for name in bounds}
    loss_rel = abs(l32 - l64) / abs(l64)
    live = abs(plain - l32) / abs(l64)
    print(f"11b tpu_products step (B={BATCH}, oracle config, wide inducing grids): loss "
          f"fp32 arm {l32!r}, float64 arm {l64!r} (rel {loss_rel:.3e}, tol "
          f"{TPU_LOSS_RTOL:.0e}); fp32 without the arm {plain!r} (rel {live:.3e} from the "
          f"arm, {live / max(loss_rel, 1e-300):.1f}x the arm's float64 gap); gradients "
          f"worst by group {by_group} (bounds {bounds}); the witness moves the arm's "
          f"gradient by up to {max(wit_arm.values()):.3e} of a leaf; the step again moves "
          f"it by up to {order['arm']:.3e} in the arm, {order['no_arm']:.3e} without; "
          "without the arm "
          f"{ {p: round(off_shares[p] / bound(p), 2) for p in TPU_LIVE_LEAVES} } x the "
          f"bound on the live leaves; sites fp32 {sites32}, float64 {sites64}, off "
          f"{sites_off}; conv5 launches {launches}; the fp32 step {1e3 * step_s:.1f} ms "
          "(its first, cuDNN's search included)")
    if sites32 != TPU_ORACLE_SITES or sites64 != TPU_ORACLE_SITES:
        fail(f"the arm's product sites {sites32} / {sites64} are not {TPU_ORACLE_SITES}")
    if any(sites_off.values()):
        fail(f"the step without the arm went through the rounded products: {sites_off}")
    if launches != 1:
        fail(f"conv5 launched {launches} times in the arm's fp32 step")
    if not loss_rel <= TPU_LOSS_RTOL:
        fail("the arm's fp32 loss disagrees with its float64 loss")
    for what, got in (("", shares), (" again", again), (" on deterministic algorithms", wit)):
        over = sorted(p for p in got if not got[p] <= bound(p))
        if over:
            fail(f"the arm's fp32 gradient{what} disagrees with its float64 gradient on {over}")
    if not live >= TPU_LIVE_RATIO * loss_rel:
        fail("the arm's loss is not told apart from the unrounded fp32 loss")
    dead = [p for p in TPU_LIVE_LEAVES if not off_shares[p] > bound(p)]
    if dead:
        fail(f"the gradient check cannot tell the arm from the unrounded step on {dead}")
    return {"loss_fp32": l32, "loss_float64": l64, "loss_rel": loss_rel,
            "loss_no_arm": plain, "no_arm_rel": live, "grad_share_worst": shares[worst],
            "grad_share_worst_leaf": worst, "grad_share_by_group": by_group,
            "grad_bounds": bounds,
            "grad_shares": shares, "again_grad_shares": again,
            "witness_grad_shares": wit, "witness_from_arm": wit_arm,
            "again_from_first": order,
            "no_arm_grad_shares": off_shares, "sites": sites32,
            "conv5_launches": launches}


def drive_tpu_oracle(conv5_mod, work: Path):
    """11c: the oracle at phase 7's defaults in the arm (--tpu_products) for
    ORACLE_SCAN_EPOCHS epochs with --no_gate, eager and --epoch_scan, as
    phase 7b does: every loss finite, skips and fallbacks printed, conv5
    once a train and recon forward (launches plus replays).  Returns (conv5
    runs by path, numbers)."""
    steps = -(-ORACLE_VOLS // BATCH)
    want = ORACLE_SCAN_EPOCHS * steps + steps
    by_path, out = {}, {}
    for scan in (False, True):
        name = "tpu_oracle_replay" if scan else "tpu_oracle_eager"
        argv = ["--work_dir", str(work / name), "--epochs", str(ORACLE_SCAN_EPOCHS),
                "--no_gate", "--tpu_products"] + (["--epoch_scan"] if scan else [])
        reset_conv5(conv5_mod)
        rc, result, t = run_oracle(argv, work / f"{name}.log")
        torch.cuda.synchronize()
        runs = conv5_mod.conv5.launches + sum(t.replays.values())
        secs = [t.epoch_seconds[e] for e in sorted(t.epoch_seconds)]
        losses = [t.loss["train"][e] for e in range(ORACLE_SCAN_EPOCHS)]
        steady = statistics.median(secs[1:])
        out[name] = dict(first_epoch_s=secs[0], steady_epoch_s=steady,
                         train_seconds=result["train_seconds"], conv5_runs=runs,
                         captures=t.captures, replays=t.replays, final_loss=losses[-1],
                         skips=result["nonfinite_skips"],
                         fallbacks=result["mvn_fallbacks"],
                         contrast=result["contrast_ratio"],
                         inside=result["task_map_mean_inside"])
        print(f"11c oracle in the arm, {ORACLE_SCAN_EPOCHS} epochs, {name}: exit {rc}, "
              f"tpu_products {result['tpu_products']}, first epoch {secs[0]:.3f} s, steady "
              f"{steady:.4f} s/epoch, training {result['train_seconds']} s; skips "
              f"{result['nonfinite_skips']}, gain-Cholesky fallbacks "
              f"{result['mvn_fallbacks']}; captures {t.captures}, replays {t.replays}; "
              f"conv5 runs {runs} (want {want}); last loss {losses[-1]}")
        if rc != 0 or result["tpu_products"] is not True or not t.config.tpu_products:
            fail(f"the {name} oracle run failed or did not run in the arm")
        if not np.isfinite(losses).all() or runs != want:
            fail(f"the {name} oracle run has a non-finite loss or did not run conv5 once "
                 "a forward")
        if scan and sum(t.replays.values()) != ORACLE_SCAN_EPOCHS * steps - len(t.captures):
            fail("the arm's epoch_scan run did not replay every step after a capture")
        by_path[name] = runs
    return by_path, out


ONE_PASS_CHECKED = ("main", "oracle_tail", "mni", "thin", "hw30", "odd-batch")


def drive_phase11(conv5_mod, lib, lap):
    """Phase 11: the TPU's product arithmetic.  Returns (conv5 runs by path,
    the numbers)."""
    out, by_path = {}, {}
    out["conv5_one_pass"] = check_conv5_one_pass(conv5_mod, lib, ONE_PASS_CHECKED)
    lap("11a_conv5_one_pass")
    free_card()
    out["step"] = drive_tpu_step(conv5_mod)
    by_path["tpu_step"] = out["step"]["conv5_launches"]
    lap("11b_tpu_step")
    free_card()
    work = Path(tempfile.mkdtemp(prefix="vaegam_tpu_oracle_"))
    try:
        paths, out["oracle"] = drive_tpu_oracle(conv5_mod, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    by_path.update(paths)
    lap("11c_tpu_oracle")
    return by_path, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler breakdown of 3 steps to this directory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vaegam_tpu_torch._device import configure_cuda_backends
    from vaegam_tpu_torch.ops import build, conv5 as conv5_mod

    t_start = last = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Seconds since the previous lap, kept under `name`."""
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = now - last
        last = now

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
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
    for name in ("adam", "convt5"):
        t0 = time.perf_counter()
        built = build.build(name)
        print(f"built {built.name} in {time.perf_counter() - t0:.1f} s")
        log = built.with_name(built.name + ".log")
        if log.exists():
            print(log.read_text().strip())
    lap("1_2_card_build")

    # 3. kernels vs plain versions
    err, timing = check_conv5(conv5_mod)
    convt5_check = check_convt5()
    adam_check = check_adam()
    lap("3_kernels")

    # 4-7. the train step; the train CLI on a NIfTI study, and its output
    # stage; the correctness oracle
    work = Path(tempfile.mkdtemp(prefix="vaegam_oracle_"))
    study_root = Path(tempfile.mkdtemp(prefix="vaegam_study_"))
    try:
        with Conv5Shapes(conv5_mod) as shapes:
            step_launches, step_adam, step_ms, all_ms, peak_gib = drive_main_path(
                conv5_mod, args.profile)
            lap("4_step")
            f64_launches, f64 = drive_float64(conv5_mod)
            lap("4b_float64")
            libs = host_libraries()
            cli_launches, cli, outputs, study = drive_cli(conv5_mod, libs, study_root)
            lap("5_6b_cli")
            oracle_launches, oracle, oracle_s, oracle_failed = drive_oracle(conv5_mod, work)
            lap("7_oracle")
            # after phase 7, which so finds cuDNN's algorithm cache as it
            # did before phase 4c existed (4c is the first to search B = 2)
            scan_launches, scan, scan_adam = drive_epoch_scan(conv5_mod)
            lap("4c_epoch_scan")
            oracle_scan_launches, scan["oracle"] = drive_oracle_scan(conv5_mod, work)
            lap("7b_oracle_scan")
        shutil.rmtree(work, ignore_errors=True)

        # 8. beta_maps on the card
        betas = drive_beta_maps()
        lap("8_beta_maps")

        # 9. data parallel: two ranks on the card, NCCL at a world of one,
        # the train CLI with --multihost on phase 5's study
        with Conv5Shapes(conv5_mod) as dp_shapes:
            dp_launches, rank_shapes, dp = drive_data_parallel(
                conv5_mod, study, cli["fp32"]["train_losses"][:DP_CLI_EPOCHS])
        lap("9_data_parallel")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(study_root, ignore_errors=True)

    # 10. conv_pack on the card (10a), then the study tools (10b-10f)
    with Conv5Shapes(conv5_mod) as p10_shapes:
        p10_launches, phase10, p10_rank_shapes = drive_phase10(conv5_mod, lap)

    # 11. the TPU's product arithmetic: conv5's one-pass path (11a), a
    # full-width step against float64 (11b), 30 oracle epochs (11c)
    with Conv5Shapes(conv5_mod) as p11_shapes:
        p11_launches, phase11 = drive_phase11(conv5_mod, lib, lap)
    phase_s["total"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": phase_s, "card": smi}))
    seen = (shapes.seen | dp_shapes.seen | rank_shapes | p10_shapes.seen | p10_rank_shapes
            | p11_shapes.seen)
    unchecked = seen - set(CONV5_SHAPES.values())
    print(f"conv5 launch shapes on the main path and the ranks: {sorted(seen)}; all "
          f"checked against the plain version in phase 3: {not unchecked}")
    if unchecked:
        fail(f"conv5 launched at shapes phase 3 did not check: {sorted(unchecked)}")
    unchecked = p11_shapes.one_pass - {CONV5_SHAPES[n] for n in ONE_PASS_CHECKED}
    print(f"conv5's one-pass launch shapes: {sorted(p11_shapes.one_pass)}; all checked "
          f"in 11a: {not unchecked}")
    if unchecked:
        fail(f"conv5's one-pass path launched at shapes 11a did not check: {sorted(unchecked)}")

    # 12. numbers (before phase 7's verdict, so that a failed draw still reports them)
    print(json.dumps({"phase10": phase10}))
    print(json.dumps({"tpu_products": phase11}))
    one = phase11["conv5_one_pass"]
    kernel = {
        "name": "conv5", "route": "cuda",
        "source": "vaegam_tpu_torch/ops/csrc/conv5.cu",
        "replaces": "vaegam_tpu/ops/pallas_conv.py:50",
        "launches": cli_launches["cli_fp32"],
        "launches_by_path": dict(train_step=step_launches, float64_step=f64_launches,
                                 **scan_launches, **cli_launches, oracle=oracle_launches,
                                 **oracle_scan_launches, **dp_launches, **p10_launches,
                                 **p11_launches),
        "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "bound_tc_ms": timing["bound_tc_ms"], "events_ms": timing["events_ms"],
        "library_events_ms": timing["library_events_ms"], "host_ms": timing["host_ms"],
        "library_host_ms": timing["library_host_ms"],
        "mni_ms": timing["mni_ms"], "mni_library_ms": timing["mni_library_ms"],
        "mni_bound_ms": timing["mni_bound_ms"], "mni_bound_tc_ms": timing["mni_bound_tc_ms"],
        "one_pass": {k: one[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "split_ms", "max_abs_err",
            "mni_ms", "mni_library_ms", "mni_bound_ms", "mni_split_ms", "hmma_one_pass",
            "hmma_split")},
    }
    eager_prof = scan["default"]["eager"]["profiled"]
    adam_kernel = {
        "name": "adam", "route": "cuda",
        "source": "vaegam_tpu_torch/ops/csrc/adam.cu",
        "replaces": "none: the JAX package's optax update, which XLA fuses into its step",
        "launches": step_adam,
        "launches_by_path": dict(train_step=step_adam, float64_step=f64["adam_launches"],
                                 **scan_adam),
        "steps_equal": {arm: adam_check[arm]["steps_equal"]
                        for arm in ("fp32", "x64_epsilon", "mni91")},
        "params": adam_check["fp32"]["params"], "leaves": adam_check["fp32"]["leaves"],
        "mni91_params": adam_check["mni91"]["params"],
        "ms": adam_check["ms"], "plain_ms": adam_check["plain_ms"],
        "graph_ms": adam_check["graph_ms"], "host_ms": adam_check["host_ms"],
        "plain_host_ms": adam_check["plain_host_ms"], "bound_ms": adam_check["bound_ms"],
        "bound_by": "bytes", "bound_bytes": adam_check["bound_bytes"],
        "in_step_ms": eager_prof["adam_ms_per_step"],
    }
    convt5_kernel = {
        "name": "convt5", "route": "cuda",
        "source": "vaegam_tpu_torch/ops/csrc/convt5.cu",
        "replaces": "none: the decoder's output layer, which the JAX package leaves to XLA "
                    "and cuDNN serves far from its bound",
        "launches": CONVT5_RUNS["train_step"], "launches_by_path": dict(CONVT5_RUNS),
        **{name: convt5_check[name] for name in convt5_check},
    }
    print(json.dumps({"kernels": [kernel, adam_kernel, convt5_kernel]}))
    print(json.dumps({"step_ms_median": step_ms, "vols_per_s": BATCH * 1e3 / step_ms,
                      "step_ms_min": min(all_ms), "step_ms_max": max(all_ms),
                      "batch": BATCH, "steps": TIMED_STEPS, "peak_mem_gib": peak_gib}))
    print(json.dumps({"float64": f64}))
    print(json.dumps({"epoch_scan": scan}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"outputs": outputs}))
    print(json.dumps({"oracle": dict(oracle, conv5_launches=oracle_launches,
                                     phase_s=oracle_s)}))
    print(json.dumps({"beta_maps": betas}))
    print(json.dumps({"data_parallel": dp}))
    print(smi)
    if oracle_failed:
        fail(oracle_failed)
    # 13. the last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
