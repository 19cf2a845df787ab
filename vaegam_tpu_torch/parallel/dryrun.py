"""A dry run of data-parallel training over n CPU ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``: n processes join a gloo
group on localhost and train the thin model (nf=2, 8 latents, 21x25x21,
the MNI grid's proportions) through both production paths: one streaming
step on a host batch that each rank cuts to its rows, and one device-cache
epoch (the whole cache on every rank, each gathering its rows of every
global batch) through the Trainer.  Every loss must be finite and equal on
every rank, and the parameters must end equal on every rank.

    python -m vaegam_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import multiprocessing
import sys

import numpy as np

_XU_RANGES = [[-2.0, 2.0]] * 6


def _rank(rank: int, n: int, coordinator: str, out) -> None:
    import torch

    from ..data import DeviceResidentLoader
    from ..models import VAEGAMConfig
    from ..train import Trainer
    from .mesh import init_multihost, leave, replica_digests

    torch.set_num_threads(1)
    mesh = init_multihost(coordinator, n, rank, device="cpu")
    try:
        config = VAEGAMConfig(nf=2, num_latents=8, img_shape=(21, 25, 21))
        b = 2 * n  # two rows a rank
        rng = np.random.default_rng(2)
        batch = {"covariates": rng.normal(size=(b, config.num_covariates)),
                 "volume": rng.uniform(0, 1, size=(b,) + config.img_shape)}
        trainer = Trainer(config, _XU_RANGES, seed=7, enable_tb=False, mesh=mesh)
        stream_loss = float(trainer.train_step(*trainer._put_batch(batch))[0])

        rng = np.random.default_rng(4)
        loader = DeviceResidentLoader.from_arrays(
            rng.uniform(0, 1, size=(4 * n,) + config.img_shape),
            rng.normal(size=(4 * n, config.num_covariates)),
            batch_size=b, shuffle=True, mesh=mesh)
        cache_loss = trainer.train_epoch(loader)
        digests = replica_digests(trainer._leaves, mesh)
    finally:
        leave(mesh)
    out.put((rank, stream_loss, cache_loss, digests))


def dryrun_multichip(n: int) -> None:
    """Train the thin model one streaming step and one device-cache epoch
    over n gloo ranks on the CPU; raises unless every rank finishes with
    finite losses equal on every rank and equal parameters."""
    from .mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, n, coordinator, out)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = sorted(out.get(timeout=600) for _ in range(n))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dry-run ranks exited with {[p.exitcode for p in procs]}")
    _, stream, cache, digests = results[0]
    if not (np.isfinite(stream) and np.isfinite(cache)):
        raise RuntimeError(f"non-finite dry-run loss: streaming {stream}, cache {cache}")
    if any(r[1:3] != (stream, cache) for r in results) or len(set(digests)) != 1:
        raise RuntimeError(f"the ranks disagree: {results}")
    print(f"dryrun_multichip({n}): streaming-path loss={stream:.4f} "
          f"device-cache epoch loss={cache:.4f}, {n} gloo ranks agree OK")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
