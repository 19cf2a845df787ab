"""Volume reconstruction + subject/group averaged NIfTI maps.

Counterpart of ``vaegam_tpu.outputs.recons``, with the same files:
  * reconstruct (vae_reg_GP.py:585-620): per batch, one forward with maps;
    for each of the 10 map keys and each element, write
    {save_dir}/vol_{n}/recon_{key}.nii with the subject's reference
    affine+header;
  * mk_single_volumes (build_model_recons.py:15-38): creates
    reconstructions/{epoch:03d}_model_recons/{subj}/ then reconstructs;
  * mk_avg_maps (build_model_recons.py:40-116): per-subject averages of the
    written per-volume files, then the grand average; {map}_avg.nii files
    under {epoch:03d}_avg_model_recons/.

The maps forward runs on the Trainer's device; the NIfTI writes are host
I/O.  The native batch writer (native/vaegam_io.cc
vaegam_nifti_write_batch_f32) encodes and writes on a C++ thread pool with
the GIL released; without it, a Python writer pool writes the same bytes.

Data parallel: every rank runs the (collective) maps forwards and receives
the global batch's maps; rank 0 alone creates the directories and writes
and averages the files, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import pandas as pd
import torch

from ..models.vaegam import MAP_KEYS
from ..parallel.mesh import is_main_process
from ..utils import nifti, nifti_native

_WRITER_THREADS = nifti_native.DEFAULT_WRITER_THREADS
# host buffer sets in rotation: one being filled by the device, one waiting
# for its files to be handed over, one being read by the writers
_HOST_BUFFERS = 3


def _flush_native(header: bytes, maps, lo: int, hi: int, img_shape, paths):
    """Write rows lo:hi of every map key (paths ordered key-major)."""
    for k, key in enumerate(MAP_KEYS):
        nifti_native.write_batch_f32(
            header, maps[key][lo:hi], img_shape,
            paths[k * (hi - lo):(k + 1) * (hi - lo)],
            n_threads=_WRITER_THREADS,
        )


def _save_f32(recon: np.ndarray, ref, path: str):
    """One file from the Python writer pool; the float32 copy (a widening on
    the float16 wire) is made on the writer's thread."""
    nifti.save(nifti.Nifti1Image(recon.astype(np.float32), ref.affine,
                                 ref.header), path)


class _Writer:
    """Hands a batch's files to the writers and returns their futures.

    The native batch writer runs on one pool thread (it has its own C++
    threads); without it a pool of Python writers takes one file each.
    Contiguous runs of one subject share one header template.  Both read
    the maps' host arrays after ``submit`` returns.
    """

    def __init__(self, ref_niis: List[str], save_dirs: List[str], img_shape):
        self.use_native = nifti_native.writer_available()
        self.pool = ThreadPoolExecutor(
            max_workers=1 if self.use_native else _WRITER_THREADS)
        self._ref_niis, self._save_dirs = ref_niis, save_dirs
        self._img_shape = img_shape
        self._refs = {}  # subj_idx -> (reference image, 352-byte header)

    def _ref(self, subj_idx: int):
        if subj_idx not in self._refs:
            ref = nifti.load(self._ref_niis[subj_idx])
            self._refs[subj_idx] = ref, nifti.encode_header(
                ref.header, self._img_shape, np.float32, ref.affine)
        return self._refs[subj_idx]

    def submit(self, sample, maps) -> list:
        """maps: key -> (n, img_dim) host array, one row per sample."""
        n = len(sample["subjid"])
        futures = []
        lo = 0
        while lo < n:
            subj_idx = int(sample["subjid"][lo])
            hi = lo
            while hi < n and int(sample["subjid"][hi]) == subj_idx:
                hi += 1
            ref, header = self._ref(subj_idx)
            paths = []
            for key in MAP_KEYS:
                for i in range(lo, hi):
                    vol_dir = os.path.join(
                        self._save_dirs[subj_idx],
                        f"vol_{int(sample['vol_num'][i])}",
                    )
                    os.makedirs(vol_dir, exist_ok=True)
                    paths.append(os.path.join(vol_dir, f"recon_{key}.nii"))
            if self.use_native:
                futures.append(self.pool.submit(
                    _flush_native, header, maps, lo, hi, self._img_shape,
                    paths,
                ))
            else:
                p = 0
                for key in MAP_KEYS:
                    for i in range(lo, hi):
                        futures.append(self.pool.submit(
                            _save_f32, maps[key][i].reshape(self._img_shape),
                            ref, paths[p],
                        ))
                        p += 1
            lo = hi
        return futures


class _HostBuffers:
    """Host buffer sets for the maps' device->host copies, reused only after
    the writes that read them have finished.

    A set is one (10, B, img_dim) tensor, pinned when the device is CUDA.
    The writers read a set's numpy views from their threads, so a set is
    handed out again only once every future of the batch that last used it
    is done; refilling it earlier would corrupt files that still pass every
    shape check.
    """

    def __init__(self, rows: int, img_dim: int, dtype, pin: bool):
        self._shape, self._dtype, self._pin = (len(MAP_KEYS), rows, img_dim), dtype, pin
        self._free: List[torch.Tensor] = []
        self._in_use: deque = deque()  # (buffer, futures) in hand-over order
        self._count = 0

    def claim(self) -> torch.Tensor:
        if not self._free and self._count >= _HOST_BUFFERS:
            buf, futures = self._in_use.popleft()
            for f in futures:
                f.result()  # surfaces a write error too
            self._free.append(buf)
        if self._free:
            return self._free.pop()
        self._count += 1
        return torch.empty(self._shape, dtype=self._dtype, pin_memory=self._pin)

    def release(self, buf: torch.Tensor, futures) -> None:
        self._in_use.append((buf, futures))

    def drain(self) -> None:
        for _, futures in self._in_use:
            for f in futures:
                f.result()
        self._in_use.clear()


def reconstruct(trainer, loader, ref_niis: List[str], save_dirs: List[str]):
    """Write recon_{key}.nii per volume per map key under each subject dir.

    ref_niis and save_dirs are indexed by the subject index of each sample
    (VAE.reconstruct, vae_reg_GP.py:585-594).

    Depth-2 pipeline: batch k+1's maps forward is enqueued, then batch k's
    10 maps are copied into host buffers (pinned, non-blocking on the card)
    and a CUDA event is recorded, and only then are batch k-1's files handed
    to the writers.  So the card computes while the host encodes and
    writes; two map blocks live on the device at once (batch k's, until its
    copy, and batch k+1's), which is what ``data.wide_eval_view`` budgets.
    A float16 wire (``recon_wire_dtype``) is widened to float32 on the host
    before encoding; the files are float32 either way.  A rank other than 0
    runs the maps forwards only.
    """
    if not is_main_process(trainer.mesh):
        for sample in loader:
            trainer.recon_maps_step(*trainer._put_batch(sample))
        return
    img_shape = tuple(trainer.config.img_shape)
    cuda = trainer.device.type == "cuda"
    writer = _Writer(ref_niis, save_dirs, img_shape)
    # host seconds by where the loop spends them: in the loader's next(), in
    # the maps forwards' enqueue (cuDNN's search for new shapes included),
    # waiting for a free host buffer (the writers are behind), waiting for
    # the copies (the card is behind), handing the files over (directories,
    # paths, submits), and waiting for the last writes
    stats = {"volumes": 0, "bytes": 0, "loader_s": 0.0, "forward_s": 0.0,
             "buffer_wait_s": 0.0, "copy_wait_s": 0.0, "handover_s": 0.0}
    t_start = time.perf_counter()

    with writer.pool:
        buffers = None

        def copy_to_host(sample, dev_maps):
            """Enqueue the maps' copies into a claimed host buffer set."""
            nonlocal buffers
            n = len(sample["subjid"])
            if buffers is None:
                buffers = _HostBuffers(n, dev_maps["base"].shape[1],
                                       dev_maps["base"].dtype, pin=cuda)
            t0 = time.perf_counter()
            buf = buffers.claim()
            stats["buffer_wait_s"] += time.perf_counter() - t0
            for j, key in enumerate(MAP_KEYS):
                buf[j, :n].copy_(dev_maps[key], non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            return sample, buf, event

        def process(sample, buf, event):
            """Wait for the copies, then hand the batch's files to the
            writers."""
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            t1 = time.perf_counter()
            n = len(sample["subjid"])
            maps = {key: buf[j, :n].numpy() for j, key in enumerate(MAP_KEYS)}
            buffers.release(buf, writer.submit(sample, maps))
            stats["copy_wait_s"] += t1 - t0
            stats["handover_s"] += time.perf_counter() - t1
            stats["volumes"] += n
            stats["bytes"] += n * len(MAP_KEYS) * (352 + 4 * int(np.prod(img_shape)))

        pending = None   # batch k: (sample, device maps), copy not enqueued
        copied = None    # batch k-1: (sample, host buffer, event)
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            sample = next(batches, None)
            t1 = time.perf_counter()
            stats["loader_s"] += t1 - t0
            if sample is None:
                break
            covs, x = trainer._put_batch(sample)
            _, aux = trainer.recon_maps_step(covs, x)    # batch k+1
            stats["forward_s"] += time.perf_counter() - t1
            now_copied = copy_to_host(*pending) if pending is not None else None
            if copied is not None:
                process(*copied)
            pending, copied = (sample, aux["maps"]), now_copied
        if pending is not None:
            last = copy_to_host(*pending)
            if copied is not None:
                process(*copied)
            process(*last)
        t0 = time.perf_counter()
        if buffers is not None:
            buffers.drain()  # surface any write error
        stats["drain_s"] = time.perf_counter() - t0
    stats["seconds"] = time.perf_counter() - t_start
    trainer.output_stats["recons"] = stats


def mk_single_volumes(loader, trainer, csv_file: str, save_dir: str):
    """Create per-subject dirs and reconstruct every volume."""
    dset = pd.read_csv(csv_file)
    subjs = dset.subjid.unique().tolist()
    ref_niis = dset.nii_path.unique().tolist()
    ckpt_num = str(trainer.epoch).zfill(3)
    subj_dirs = []
    for subj in subjs:
        subj_dir = os.path.join(
            save_dir, "reconstructions", f"{ckpt_num}_model_recons", subj
        )
        if is_main_process(trainer.mesh):
            os.makedirs(subj_dir, exist_ok=True)
        subj_dirs.append(subj_dir)
    reconstruct(trainer, loader, ref_niis, subj_dirs)


def mk_avg_maps(csv_file: str, trainer, save_dir: str,
                mk_motion_maps: bool = False):
    """Subject-level and grand-average maps from the written per-volume files.

    Re-reads the recon_{key}.nii files exactly like the reference
    (build_model_recons.py:86-92), so the output is a pure function of what
    is on disk: float64 sums in directory-listing order, decoded 64 files
    at a time.  Rank 0's alone under a mesh.
    """
    if not is_main_process(trainer.mesh):
        return
    t0 = time.perf_counter()
    img_shape = tuple(trainer.config.img_shape)
    ckpt_num = str(trainer.epoch).zfill(3)
    sngl_vols_dir = os.path.join(
        save_dir, "reconstructions", f"{ckpt_num}_model_recons"
    )
    avg_vols_dir = os.path.join(
        save_dir, "reconstructions", f"{ckpt_num}_avg_model_recons"
    )
    os.makedirs(avg_vols_dir, exist_ok=True)
    dset = pd.read_csv(csv_file)
    ref_niis = dset.nii_path.unique().tolist()
    subjs = dset.subjid.unique().tolist()
    ref_cache = {}  # one 4D reference load per subject, reused across keys
    # reference order: base, task, full_rec, then motion, then sex
    maps = ["base", "task", "full_rec", "x_mot", "y_mot", "z_mot",
            "pitch_mot", "roll_mot", "yaw_mot", "sex"]
    if not mk_motion_maps:
        maps = [maps[i] for i in (0, 1, 2, 9)]
    for key in maps:
        gd_avg = np.zeros(img_shape, np.float64)
        for s, subj in enumerate(subjs):
            subj_dir = os.path.join(sngl_vols_dir, subj)
            vol_dirs = os.listdir(subj_dir)
            subj_avg_dir = os.path.join(avg_vols_dir, subj)
            os.makedirs(subj_avg_dir, exist_ok=True)
            paths = [os.path.join(subj_dir, vd, f"recon_{key}.nii")
                     for vd in vol_dirs]
            subj_map = np.zeros(img_shape, np.float64)
            for lo in range(0, len(paths), 64):
                for vol in nifti_native.decode_many_f32(paths[lo:lo + 64]):
                    subj_map += vol
            subj_map /= len(vol_dirs)
            _save_map(subj_map, ref_niis[s], subj_avg_dir, key, ref_cache)
            gd_avg += subj_map
        gd_avg /= len(subjs)
        _save_map(gd_avg, ref_niis[0], avg_vols_dir, key, ref_cache)
    trainer.output_stats["avg_maps_s"] = time.perf_counter() - t0


def _save_map(map_arr, reference, save_dir, ext, ref_cache=None):
    if ref_cache is None:
        ref_cache = {}
    if reference not in ref_cache:
        ref_cache[reference] = nifti.load(reference)
    ref = ref_cache[reference]
    nifti.save(
        nifti.Nifti1Image(map_arr.astype(np.float32), ref.affine, ref.header),
        os.path.join(save_dir, f"{ext}_avg.nii"),
    )
