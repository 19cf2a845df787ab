"""Encoder conv5: stride-1 VALID 3x3x3 conv plus bias, fp32, NCDHW.

Counterpart of ``vaegam_tpu/ops/pallas_conv.py`` (``conv3d_s1_pallas``).
  * ``conv5_cuda``  -- the hand-written Hopper kernel (``csrc/conv5.cu``),
    built at first use by ``ops.build``; counts its launches in
    ``conv5.launches``.
  * ``conv5_plain`` -- the plain PyTorch version: an explicit 27-tap
    shifted-slice sum.  The CPU path and the on-card comparison use it.
  * ``conv5``       -- the op the encoder calls: an autograd Function whose
    forward is the kernel on CUDA tensors and the plain version on CPU
    tensors, and whose backward is torch's conv gradients plus a sum, as
    the TPU kernel's backward was XLA's (``_vjp_bwd``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn.grad import conv3d_input, conv3d_weight

# Largest dynamic shared memory a Hopper block may opt into (227 KB).
MAX_SMEM_BYTES = 232448


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from .build import load

    lib = load("conv5")
    lib.conv5_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.conv5_fwd.restype = ctypes.c_int
    return lib


def smem_bytes(ci: int, co: int, h: int, w: int) -> int:
    """Dynamic shared memory one block of the kernel needs (its 3 input
    z-slabs plus the whole weight)."""
    return 4 * (3 * ci * h * w + 27 * ci * co)


def check_kernel_inputs(x, w, b) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv5: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv5: {name} must be contiguous")
    if x.dim() != 5:
        raise ValueError(f"conv5: x must be (B, Ci, D, H, W), got {tuple(x.shape)}")
    bsz, ci, d, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError(f"conv5: w {tuple(w.shape)} / b {tuple(b.shape)} do "
                         f"not fit x with {ci} channels")
    if min(d, h, wd) < 3 or bsz < 1:
        raise ValueError(f"conv5: x {tuple(x.shape)} too small for a 3x3x3 VALID conv")
    if smem_bytes(ci, co, h, wd) > MAX_SMEM_BYTES:
        raise ValueError(f"conv5: x {tuple(x.shape)} needs more shared memory "
                         "than one block has")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"conv5: {name} must be a CUDA tensor on x's device")


def conv5_cuda(x, w, b):
    """Launch the kernel on the current stream; returns y (B, Co, D-2, H-2, W-2)."""
    check_kernel_inputs(x, w, b)
    lib = _library()
    bsz, ci, d, h, wd = x.shape
    co = w.shape[0]
    y = torch.empty((bsz, co, d - 2, h - 2, wd - 2), device=x.device,
                    dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv5_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), bsz, ci, co, d, h, wd, stream)
    if err != 0:
        raise RuntimeError(f"conv5 kernel launch failed with CUDA error {err}")
    conv5.launches += 1
    return y


def conv5_plain(x, w, b):
    """Plain PyTorch version: sum over the 27 taps of shifted-slice products."""
    do, ho, wo = (s - 2 for s in x.shape[2:])
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = torch.einsum(
                    "bcdhw,oc->bodhw",
                    x[:, :, dz:dz + do, dy:dy + ho, dx:dx + wo],
                    w[:, :, dz, dy, dx],
                )
                acc = tap if acc is None else acc + tap
    return acc + b.reshape(1, -1, 1, 1, 1)


class _Conv5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv5_cuda(x, w, b) if x.is_cuda else conv5_plain(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_input(x.shape, w, g)
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight(x, w.shape, g)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3, 4))
        return dx, dw, db


def conv5(x, w, b):
    """Stride-1 VALID 3x3x3 conv plus bias: x (B,Ci,D,H,W), w (Co,Ci,3,3,3), b (Co,)."""
    return _Conv5.apply(x, w, b)


conv5.launches = 0  # kernel launches, counted by conv5_cuda
