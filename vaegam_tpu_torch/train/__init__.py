from .checkpoint import checkpoint_filename, load_checkpoint, save_checkpoint  # noqa: F401
from .loop import Trainer  # noqa: F401
