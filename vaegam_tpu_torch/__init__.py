"""PyTorch/CUDA port of vaegam_tpu (the JAX package stays the reference).

Layout mirrors ``vaegam_tpu`` module for module; every function takes an
explicit ``device`` or works on the tensors it is given.  Entry points
(``init_model``, ``Trainer``, the loaders, ``python -m
vaegam_tpu_torch.cli.train``) run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``); without a card and without that request
they raise.

The encoder's conv5 runs through a hand-written CUDA kernel
(``ops/csrc/conv5.cu``) on CUDA tensors and through its plain PyTorch version
on CPU tensors.
"""

from .models import MAP_KEYS, VAEGAMConfig, forward, init_model  # noqa: F401
from .train import Trainer  # noqa: F401
