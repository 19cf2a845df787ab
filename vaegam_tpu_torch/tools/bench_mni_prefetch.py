"""MNI-grid loader bench: the synchronous DataLoader against the PrefetchLoader
(and the device caches) on the card.

Counterpart of ``vaegam_tpu.tools.bench_mni_prefetch``.  At the 91x109x91
MNI grid a multi-subject study outgrows the device cache, and a host
loader then feeds every step: the synchronous ``DataLoader`` decodes,
stacks and copies each batch in line with the step; ``PrefetchLoader``
overlaps that with the device's work (a worker decodes into pinned
buffers, a side stream copies).  This tool trains the full-width model
(nf=8, 32 latents, fp32) on a synthetic MNI study through each loader
kind: one warm-up epoch (cuDNN's search, host caches), then ``--epochs``
timed epochs, end to end in vols/s.  The device caches are there for
scale: the fp32 cache and the bfloat16 one (their upload timed apart).

    python -m vaegam_tpu_torch.tools.bench_mni_prefetch [--n_vols 49]
        [--n_subjs 2] [--batch 8] [--epochs 2]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

from .._device import resolve_device
from .common import build_dataset, emit, sync

LOADERS = ("data", "prefetch", "prefetch_bf16_wire", "cache_fp32", "cache_bf16")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_subjs", type=int, default=2)
    p.add_argument("--n_vols", type=int, default=49)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--loaders", nargs="+", choices=LOADERS, default=list(LOADERS))
    p.add_argument("--img_shape", type=int, nargs=3, default=[91, 109, 91])
    p.add_argument("--nf", type=int, default=8)
    p.add_argument("--num_latents", type=int, default=32)
    p.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..data import DataLoader, DeviceResidentLoader, FMRIDataset, PrefetchLoader
    from ..models import VAEGAMConfig
    from ..train import Trainer

    img_shape = tuple(args.img_shape)
    root = tempfile.mkdtemp(prefix="mni_bench_")
    try:
        csv = build_dataset(root, args.n_subjs, args.n_vols, img_shape, 80, "mni_train.csv")
        ds = FMRIDataset(csv)
        n = len(ds)
        config = VAEGAMConfig(nf=args.nf, num_latents=args.num_latents, img_shape=img_shape)
        trainer = Trainer(config, [[-2.0, 2.0]] * 6, None, seed=1, enable_tb=False,
                          device=device)
        kw = dict(batch_size=args.batch, shuffle=True, seed=3, device=device)
        makers = {
            "data": lambda: DataLoader(ds, args.batch, shuffle=True, seed=3),
            "prefetch": lambda: PrefetchLoader(ds, depth=args.depth, **kw),
            "prefetch_bf16_wire": lambda: PrefetchLoader(ds, depth=args.depth,
                                                         transfer_dtype="bfloat16", **kw),
            "cache_fp32": lambda: DeviceResidentLoader(ds, **kw),
            "cache_bf16": lambda: DeviceResidentLoader(ds, cache_dtype="bfloat16", **kw),
        }
        results = {"tool": "bench_mni_prefetch", "device": str(device),
                   "img_shape": list(img_shape), "batch": args.batch, "n_vols_total": n,
                   "epochs": args.epochs, "vols_per_s": {}, "upload_s": {}}
        for name in args.loaders:
            try:
                loader = makers[name]()
            except ValueError as e:  # over the device cache's budget
                results["vols_per_s"][name] = f"skipped: {e}"
                continue
            if hasattr(loader, "build_seconds"):
                results["upload_s"][name] = loader.build_seconds["upload"]
            trainer.train_epoch(loader)  # warm-up: cuDNN's search, host caches
            sync(device)
            t0 = time.perf_counter()
            for _ in range(args.epochs):
                trainer.train_epoch(loader)
            sync(device)
            vps = args.epochs * n / (time.perf_counter() - t0)
            results["vols_per_s"][name] = vps
            print(f"{name}: {vps:.2f} vols/s end to end", flush=True)
            del loader
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return emit(results)


if __name__ == "__main__":
    main()
