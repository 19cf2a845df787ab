"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

conv5 (``csrc/conv5.cu``) replaces the one Pallas kernel of the JAX package,
``vaegam_tpu/ops/pallas_conv.py::_conv5_kernel``.  adam (``csrc/adam.cu``)
is the train step's guarded Adam update, which the JAX package leaves to
XLA's fusion and eager PyTorch would run as ~1,330 small kernels.  convt5
(``csrc/convt5.cu``) is the decoder's output layer in fp32, which the JAX
package leaves to XLA and cuDNN serves far from its bytes bound.  Kernels
build at first use (``ops.build``); importing this package needs neither
nvcc nor a card.
``packed_conv`` (the ``conv_pack`` knob) and ``convt`` (polyphase
transposed convs) are rewrites of stock convs, not kernels.
"""

from . import convt  # noqa: F401
