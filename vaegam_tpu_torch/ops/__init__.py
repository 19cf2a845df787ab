"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

conv5 (``csrc/conv5.cu``) replaces the one Pallas kernel of the JAX package,
``vaegam_tpu/ops/pallas_conv.py::_conv5_kernel``.  Kernels build at first
use (``ops.build``); importing this package needs neither nvcc nor a card.
``packed_conv`` (the ``conv_pack`` knob) and ``convt`` (polyphase
transposed convs) are rewrites of stock convs, not kernels.
"""

from . import convt  # noqa: F401
