"""Post-hoc outputs: NIfTI reconstructions, averaged maps, GP plots, latents."""

from .recons import mk_avg_maps, mk_single_volumes, reconstruct
from .gp_plots import plot_GPs
from .latents import project_latent

__all__ = [
    "reconstruct",
    "mk_single_volumes",
    "mk_avg_maps",
    "plot_GPs",
    "project_latent",
]
