"""A dry run of data-parallel training over n ranks (CPU ranks by default).

Counterpart of ``__graft_entry__.dryrun_multichip``: n processes join a gloo
group on localhost and train the thin model (nf=2, 8 latents, 21x25x21,
the MNI grid's proportions) through both production paths: one streaming
step on a host batch that each rank cuts to its rows, and one device-cache
epoch (the whole cache on every rank, each gathering its rows of every
global batch) through the Trainer.  Every loss must be finite and equal on
every rank, and the parameters must end equal on every rank.
:func:`run_ranks` runs such a dry run for another model, cache and device
(the full-shape MNI run of ``tools.mni_mesh_dryrun``, on the card by
default: ranks that share a card join over gloo, ranks with a card each
over NCCL).

    python -m vaegam_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import multiprocessing
import sys

import numpy as np

_XU_RANGES = [[-2.0, 2.0]] * 6
# the dryrun_multichip run: the thin model, a streaming step of two rows a
# rank, a float32 cache of four rows a rank at two rows a rank a batch
THIN_SPEC = dict(config=dict(nf=2, num_latents=8, img_shape=(21, 25, 21)),
                 stream=True, cache_rows=4, batch_rows=2, cache_dtype="float32",
                 glm_scale=None, device="cpu")


def _rank(rank: int, n: int, coordinator: str, out, spec: dict) -> None:
    import torch

    from ..data import DeviceResidentLoader
    from ..models import VAEGAMConfig
    from ..ops import conv5 as conv5_mod
    from ..train import Trainer
    from .mesh import init_multihost, leave, replica_digests

    torch.set_num_threads(1)
    mesh = init_multihost(coordinator, n, rank, device=spec["device"])
    try:
        config = VAEGAMConfig(**spec["config"])
        b = spec["batch_rows"] * n
        glm = None
        if spec["glm_scale"] is not None:
            glm = (np.random.default_rng(0).normal(size=(config.img_dim, 9))
                   * spec["glm_scale"]).astype(np.float32)
        trainer = Trainer(config, _XU_RANGES, glm, seed=7, enable_tb=False, mesh=mesh)
        stream_loss = None
        if spec["stream"]:
            rng = np.random.default_rng(2)
            batch = {"covariates": rng.normal(size=(b, config.num_covariates)),
                     "volume": rng.uniform(0, 1, size=(b,) + config.img_shape)}
            stream_loss = float(trainer.train_step(*trainer._put_batch(batch))[0])

        rng = np.random.default_rng(4)
        rows = spec["cache_rows"] * n
        loader = DeviceResidentLoader.from_arrays(
            rng.uniform(0, 1, size=(rows,) + config.img_shape),
            rng.normal(size=(rows, config.num_covariates)),
            batch_size=b, shuffle=True, mesh=mesh, cache_dtype=spec["cache_dtype"])
        cache_loss = trainer.train_epoch(loader)
        digests = replica_digests(trainer._leaves, mesh)
    finally:
        leave(mesh)
    out.put((rank, stream_loss, cache_loss, digests,
             dict(backend=mesh.backend, device=str(mesh.device),
                  conv5_launches=conv5_mod.conv5.launches)))


def run_ranks(n: int, spec: dict, timeout: float = 600):
    """Run `spec`'s dry run over n ranks on `spec["device"]` ("cpu", or
    "cuda": rank r on card r mod the visible cards); returns
    (streaming-step loss or None, device-cache epoch loss, each rank's
    {"backend", "device", "conv5_launches"}) after checking that every rank
    finished with finite losses equal on every rank and equal parameters
    (raises otherwise)."""
    from .mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, n, coordinator, out, spec))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = sorted(out.get(timeout=timeout) for _ in range(n))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dry-run ranks exited with {[p.exitcode for p in procs]}")
    _, stream, cache, digests, _ = results[0]
    if not ((stream is None or np.isfinite(stream)) and np.isfinite(cache)):
        raise RuntimeError(f"non-finite dry-run loss: streaming {stream}, cache {cache}")
    if any(r[1:3] != (stream, cache) for r in results) or len(set(digests)) != 1:
        raise RuntimeError(f"the ranks disagree: {results}")
    return stream, cache, [r[4] for r in results]


def dryrun_multichip(n: int) -> None:
    """Train the thin model one streaming step and one device-cache epoch
    over n gloo ranks on the CPU; raises unless every rank finishes with
    finite losses equal on every rank and equal parameters."""
    stream, cache, _ = run_ranks(n, THIN_SPEC)
    print(f"dryrun_multichip({n}): streaming-path loss={stream:.4f} "
          f"device-cache epoch loss={cache:.4f}, {n} gloo ranks agree OK")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
