"""Data pipeline: CSV-driven fMRI volume dataset and loaders."""

from .dataset import FMRIDataset, DataLoader, setup_data_loaders, GLOBAL_SCALE
from .device_cache import DeviceResidentLoader, setup_device_loaders
from .prefetch import PrefetchLoader, setup_prefetch_loaders

__all__ = ["FMRIDataset", "DataLoader", "setup_data_loaders", "GLOBAL_SCALE",
           "DeviceResidentLoader", "setup_device_loaders",
           "PrefetchLoader", "setup_prefetch_loaders", "wide_eval_view"]


def wide_eval_view(loader, img_dim, width=128, max_map_bytes=1.5 * 2**30):
    """A wider-batch unshuffled view of a loader for the output stage.

    The output stage's forwards run at the training batch size unless
    ``--eval_batch_size`` widens them.  Outputs are not bit-identical across
    widths: the batch-statistics norms make every forward depend on the
    batch, which is why the CLI keeps this opt-in.

    The width is capped so that TWO 10 x B x img_dim fp32 map blocks stay
    under ``max_map_bytes``: the depth-2 recon pipeline (outputs/recons.py)
    holds batch k's maps for their copy to the host while batch k+1's
    forward runs.  A device cache is shared (no second upload); a prefetch
    loader becomes an unshuffled one over the same dataset on the same wire
    (``--stream_dtype``: float16 and bfloat16 quantize differently); a host
    loader becomes an unshuffled DataLoader over the same dataset.
    """
    cap = int(max_map_bytes // (2 * 10 * img_dim * 4))
    eval_bs = max(loader.batch_size, min(width, cap))
    if eval_bs <= loader.batch_size:
        return loader
    if isinstance(loader, DeviceResidentLoader):
        return DeviceResidentLoader.sharing_cache(loader, batch_size=eval_bs,
                                                  shuffle=False)
    if isinstance(loader, PrefetchLoader):
        return PrefetchLoader(loader.dataset, eval_bs, shuffle=False, depth=loader.depth,
                              workers=loader.workers, transfer_dtype=loader.transfer_dtype,
                              device=loader.device, mesh=loader.mesh)
    return DataLoader(loader.dataset, eval_bs, shuffle=False)
