"""Data pipeline: CSV-driven fMRI volume dataset and loaders.

The prefetch loader (pinned buffers, a copy stream) and ``wide_eval_view``
are not ported yet (ROADMAP module items 5 and 7).
"""

from .dataset import FMRIDataset, DataLoader, setup_data_loaders, GLOBAL_SCALE
from .device_cache import DeviceResidentLoader, setup_device_loaders

__all__ = ["FMRIDataset", "DataLoader", "setup_data_loaders", "GLOBAL_SCALE",
           "DeviceResidentLoader", "setup_device_loaders"]
