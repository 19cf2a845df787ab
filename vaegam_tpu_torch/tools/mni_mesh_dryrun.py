"""The data-parallel dry run at the full MNI model shape.

Counterpart of ``vaegam_tpu.tools.mni_mesh_dryrun`` (an 8-way virtual-mesh
run of the JAX package).  ``parallel.dryrun`` trains the thin model; this
tool runs the same machinery (``parallel.dryrun.run_ranks``: n processes in
one group on localhost) at the flagship shape: nf=8, 32 latents,
91x109x91 volumes, the JAX tool's config (GLM maps at scale 10, no HRF on
the task gain, joint norm statistics, the Cholesky-parameterized GP
covariances) and a float16 device cache of two global batches of one row a
rank.  Each rank gathers its row of every global batch; the epoch's losses
and the parameters must end equal on every rank.

The ranks run on the card by default (rank r on card r mod the visible
cards; ``--device cuda:N`` puts every rank on card N): ranks that share a
card join over gloo with CUDA tensors, ranks with a card each over NCCL.  ``--device cpu`` runs them on the CPU over
gloo; every rank then holds a full MNI forward and backward in host
memory, so ``--n_ranks`` is bounded by the host's memory.

The JAX tool trains that epoch as one ``epoch_scan`` segment.  The port's
``epoch_scan`` records the step's collectives into a CUDA graph, which gloo
cannot do (it needs NCCL and a card a rank), so the Trainer refuses it
under gloo; this run trains the eager device-cache epoch on every backend,
and its JSON line says so (``"epoch_scan": false``).

    python -m vaegam_tpu_torch.tools.mni_mesh_dryrun [--n_ranks 8] [--device cpu]

Prints one JSON line, with each rank's backend, device and conv5 launches.
"""

from __future__ import annotations

import argparse
import time

from .._device import resolve_device
from .common import emit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_ranks", type=int, default=8)
    p.add_argument("--img_shape", type=int, nargs=3, default=[91, 109, 91])
    p.add_argument("--nf", type=int, default=8)
    p.add_argument("--num_latents", type=int, default=32)
    p.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..parallel.dryrun import run_ranks

    config = dict(nf=args.nf, num_latents=args.num_latents, img_shape=tuple(args.img_shape),
                  glm_reg_scale=10.0, neural_covariates=False, fused_norm_stats=True,
                  qu_s_cholesky=True)
    spec = dict(config=config, stream=False, cache_rows=2, batch_rows=1,
                cache_dtype="float16", glm_scale=0.01, device=str(device))
    t0 = time.perf_counter()
    _, loss, ranks = run_ranks(args.n_ranks, spec, timeout=3600)
    return emit({"tool": "mni_mesh_dryrun", "n_ranks": args.n_ranks, "device": str(device),
                 "backend": ranks[0]["backend"], "ranks": ranks,
                 "img_shape": list(args.img_shape), "nf": args.nf,
                 "num_latents": args.num_latents, "cache_dtype": "float16",
                 "batch_rows": spec["batch_rows"], "steps": spec["cache_rows"],
                 "epoch_scan": False,
                 "epoch_scan_note": "not run: gloo cannot capture its collectives in a CUDA "
                                    "graph; the eager device-cache epoch ran",
                 "epoch_loss": loss, "seconds": time.perf_counter() - t0, "ok": True})


if __name__ == "__main__":
    main()
