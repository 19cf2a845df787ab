"""Output-stage (reconstruction) bench: a sweep of the eval batch width.

Counterpart of ``vaegam_tpu.tools.bench_recon``.  The output stage runs
its forwards at the training batch unless ``--eval_batch_size`` widens
them (``data.wide_eval_view``).  For each width this tool records, on a
synthetic study at the reference grid held in the device cache:

  * maps-forward throughput (the recon stage's device loop: encoder, the
    9-way decode and the gains, on the ``--recon_wire_dtype`` wire; no host
    copy, no file);
  * the same with each batch's maps copied to the host (no file);
  * the wall time of the whole recon stage (``outputs.mk_single_volumes``:
    its pipelined copies and the NIfTI writer);
  * the averaged-maps stage (``outputs.mk_avg_maps``), which re-reads every
    written map.

    python -m vaegam_tpu_torch.tools.bench_recon [--n_subjs 2] [--n_vols 98]
        [--widths 32 128 256]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

from .._device import resolve_device
from .common import build_dataset, emit, sync


def _epoch(trainer, loader, pull: bool) -> float:
    """Seconds of one pass of the maps step over the loader (and the maps'
    copy to the host when `pull`), ending in a sync."""
    sync(trainer.device)
    t0 = time.perf_counter()
    for sample in loader:
        covs, x = trainer._put_batch(sample)
        _, aux = trainer.recon_maps_step(covs, x)
        if pull:
            for v in aux["maps"].values():
                v.cpu()
    sync(trainer.device)
    return time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_subjs", type=int, default=2)
    p.add_argument("--n_vols", type=int, default=98)
    p.add_argument("--widths", type=int, nargs="+", default=[32, 128, 256])
    p.add_argument("--nf", type=int, default=8,
                   help="encoder feature width (reference default 8)")
    p.add_argument("--num_latents", type=int, default=32)
    p.add_argument("--recon_wire_dtype", choices=["float32", "float16"], default="float32")
    p.add_argument("--img_shape", type=int, nargs=3, default=[41, 49, 35],
                   metavar=("D", "H", "W"))
    p.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..data import DeviceResidentLoader, FMRIDataset, wide_eval_view
    from ..models import VAEGAMConfig
    from ..outputs.recons import mk_avg_maps, mk_single_volumes
    from ..train import Trainer

    img_shape = tuple(args.img_shape)
    root = tempfile.mkdtemp(prefix="bench_recon_")
    try:
        csv = build_dataset(root, args.n_subjs, args.n_vols, img_shape, 60, "bench_recon.csv")
        ds = FMRIDataset(csv)
        n = len(ds)
        config = VAEGAMConfig(nf=args.nf, num_latents=args.num_latents, img_shape=img_shape)
        trainer = Trainer(config, [[-2.0, 2.0]] * 6, None, seed=1, enable_tb=False,
                          recon_wire_dtype=args.recon_wire_dtype, device=device)
        base = DeviceResidentLoader(ds, batch_size=32, shuffle=False, device=device)
        results = {"tool": "bench_recon", "device": str(device), "n_vols_total": n,
                   "img_shape": list(img_shape), "recon_wire_dtype": args.recon_wire_dtype,
                   "widths": {}}
        for width in args.widths:
            if width >= base.batch_size:
                loader = wide_eval_view(base, config.img_dim, width=width)
            else:  # narrower than the training batch: a view over the same cache
                loader = DeviceResidentLoader.sharing_cache(base, batch_size=width)
            eff = loader.batch_size
            _epoch(trainer, loader, pull=False)  # cuDNN's search for the widths
            fwd_s = _epoch(trainer, loader, pull=False)
            pull_s = _epoch(trainer, loader, pull=True)
            out = os.path.join(root, f"recons_w{eff}")
            os.makedirs(out, exist_ok=True)
            t0 = time.perf_counter()
            mk_single_volumes(loader, trainer, csv, out)
            recon_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            mk_avg_maps(csv, trainer, out, mk_motion_maps=True)
            avg_s = time.perf_counter() - t0
            shutil.rmtree(out)
            results["widths"][str(eff)] = {
                "requested": width, "fwd_vols_per_s": n / fwd_s,
                "fwd_pull_vols_per_s": n / pull_s, "full_recon_vols_per_s": n / recon_s,
                "full_recon_s": recon_s, "avg_maps_s": avg_s,
                "recon_stats": {k: v for k, v in trainer.output_stats.get("recons", {}).items()
                                if isinstance(v, (int, float))}}
            print(f"width {eff}: fwd {n / fwd_s:.2f} | fwd+pull {n / pull_s:.2f} | "
                  f"full recon {n / recon_s:.2f} vols/s | avg maps {avg_s:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return emit(results)


if __name__ == "__main__":
    main()
