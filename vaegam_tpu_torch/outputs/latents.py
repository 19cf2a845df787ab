"""Latent-space 2D projection plot (reference vae_reg_GP.py:542-583).

Counterpart of ``vaegam_tpu.outputs.latents``: encodes the full
UnShuffled_train set to posterior means, projects them to 2D, and scatters
per-subject chunks of ``split`` volumes into ``{epoch:03d}_temp.pdf``.

Projection backend chain, as in the JAX package:
  1. umap-learn if installed, with the reference's settings;
  2. the native UMAP (outputs/umap_native.py), its layout optimized on the
     Trainer's device;
  3. sklearn's SpectralEmbedding on the same kNN graph, if the native
     UMAP's layout is not finite (an error in it is raised, not hidden);
  4. PCA for inputs of 25 rows or fewer.
The backend that produced the projection is returned and recorded, so a
stand-in never passes for the native UMAP unnoticed.

Data parallel: every rank runs the (collective) encode and receives the
whole latent set; the projection and the plot are rank 0's, as in the JAX
package.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..models.networks import encode
from ..parallel.mesh import all_gather_rows, is_main_process
from ..utils.tb import pyplot


def _project_2d(latent: np.ndarray, device="cpu", timings=None):
    """(projection (N, 2), backend name)."""
    try:
        from umap import UMAP

        transform = UMAP(
            n_components=2, n_neighbors=20, min_dist=0.1,
            metric="euclidean", random_state=42,
        )
        return transform.fit_transform(latent), "umap-learn"
    except ImportError:
        pass
    if len(latent) > 25:
        from .umap_native import umap_embed

        out = umap_embed(latent, n_neighbors=min(20, len(latent) - 2),
                         min_dist=0.1, seed=42, device=device, timings=timings)
        if np.all(np.isfinite(out)):
            return out, "umap_native"
        print("[latents] the native UMAP layout is not finite; falling back "
              "to the spectral embedding")
        # UMAP's own initialization: spectral embedding of the kNN graph,
        # with the reference's neighborhood size
        from sklearn.manifold import SpectralEmbedding

        emb = SpectralEmbedding(
            n_components=2, n_neighbors=min(20, len(latent) - 1),
            random_state=42,
        )
        out = emb.fit_transform(latent)
        if np.all(np.isfinite(out)):
            return out, "spectral"
    from sklearn.decomposition import PCA

    return PCA(n_components=2, random_state=42).fit_transform(latent), "pca"


def project_latent(trainer, loaders_dict, save_dir, title=None, split=98):
    """Encode, project and plot; returns (latent, projection, backend)
    (projection and backend None on a rank other than 0).

    The encode is fp32 whatever the recipe (the JAX package's ``encode(p,
    x, nf)``), with conv5 through the kernel when ``config.conv5_kernel``.
    Seconds and the backend land in ``trainer.output_stats``.
    """
    mesh = trainer.mesh
    stats = trainer.output_stats
    filename = str(trainer.epoch).zfill(3) + "_temp.pdf"
    file_path = os.path.join(save_dir, filename)

    t0 = time.perf_counter()
    chunks = []
    with torch.no_grad():
        for sample in loaders_dict["UnShuffled_train"]:
            covs, x = trainer._put_batch(sample)
            mu = encode(trainer.params["enc"], x, trainer.config.conv5_kernel,
                        mesh=mesh, global_rows=len(covs),
                        tpu_products=trainer.config.tpu_products)[0]
            if mesh is not None:
                mu = all_gather_rows(mu, mesh, len(covs))
            chunks.append(mu.cpu().numpy())
    latent = np.concatenate(chunks, axis=0)
    t1 = time.perf_counter()
    if not is_main_process(mesh):
        stats.update(latent_encode_s=t1 - t0)
        return latent, None, None
    umap_timings = {}
    projection, backend = _project_2d(latent, trainer.device, umap_timings)
    t2 = time.perf_counter()
    stats.update(latent_encode_s=t1 - t0, umap_s=t2 - t1, umap_backend=backend,
                 **{f"umap_{k}": v for k, v in umap_timings.items()})

    try:
        plt = pyplot()
    except ImportError as e:
        print(f"[outputs] latent plot {file_path} not written: {e}")
        return latent, projection, backend
    c_list = ["b", "g", "r", "c", "m", "y", "k", "orange", "blueviolet",
              "hotpink", "lime", "skyblue", "teal", "sienna"]
    colors = itertools.cycle(c_list)
    plt.clf()
    for i in range(0, len(latent), split):
        plt.scatter(projection[i:i + split, 0], projection[i:i + split, 1],
                    color=next(colors), s=1.0, alpha=0.6)
        plt.axis("off")
    if title is not None:
        plt.title(title)
    plt.savefig(file_path)
    stats["latent_plot_s"] = time.perf_counter() - t2
    return latent, projection, backend
