"""Encoder conv5: stride-1 VALID 3x3x3 conv plus bias, fp32, NCDHW.

Counterpart of ``vaegam_tpu/ops/pallas_conv.py`` (``conv3d_s1_pallas``).
  * ``conv5_cuda``  -- the hand-written Hopper kernel (``csrc/conv5.cu``),
    built at first use by ``ops.build``; counts its launches in
    ``conv5.launches``, and a launch recorded into a CUDA graph, which runs
    only when the graph is replayed, in ``conv5.captured`` (the graph's
    owner counts its replays: ``Trainer.replays``).
  * ``conv5_plain`` -- the plain PyTorch version: an explicit 27-tap
    shifted-slice sum.  The CPU path and the on-card comparison use it.
  * ``conv5``       -- the op the encoder calls: an autograd Function whose
    forward is the kernel on CUDA tensors and the plain version on CPU
    tensors, and whose backward is torch's conv gradients plus a sum, as
    the TPU kernel's backward was XLA's (``_vjp_bwd``).

``one_pass=True`` is the TPU's own arithmetic for the Pallas kernel's
``jnp.dot``, which carries no precision, so Mosaic's default applies: one
bfloat16 pass, float32 accumulation.  The kernel's one-pass path rounds
both operands to bfloat16 (to nearest even) as it stages them and issues
one tensor-core product per k step; the plain version is the 27-tap sum on
``products.round_bf16`` operands; the backward rounds the cotangent and
the saved operands as every other product of the TPU arm does
(``ops.products``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.nn.grad import conv3d_input, conv3d_weight

from . import products
from .products import round_bf16

# Largest dynamic shared memory a Hopper block may opt into (227 KB).
MAX_SMEM_BYTES = 232448
WARPS = 8                 # csrc/conv5.cu kWarps
SLICE_STEPS = 7           # csrc/conv5.cu kSliceSteps: k8 steps a warp holds
MAX_TILES = 4             # csrc/conv5.cu kMaxTiles: m16 tiles a block at most


class Conv5Plan(NamedTuple):
    """How csrc/conv5.cu tiles one input shape: the kernel reads these ints
    in this order (its ``struct Plan``).  Offsets and strides are in 4-byte
    words of dynamic shared memory."""

    ci: int
    co: int
    d: int
    h: int
    w: int
    rows: int        # output (y, x) rows a block covers
    nchunks: int     # blocks per output z plane
    mt: int          # m16 tiles a block
    nslices: int     # K slices of SLICE_STEPS k8 steps (27*Ci padded)
    ngroups: int     # n16 groups: Co padded to 16
    ds: int          # words per (ci, dz) input run
    cs: int          # words per channel
    rstride: int     # words per partial-sum row
    red_off: int
    koff_off: int
    rowoff_off: int
    bias_off: int
    smem: int        # bytes of dynamic shared memory
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def plan(bsz: int, ci: int, co: int, d: int, h: int, w: int) -> Conv5Plan:
    """Tile an input (bsz, ci, d, h, w) for the kernel.

    A block covers (b, z_out, a chunk of the output plane's rows in (y, x)
    order): at most MAX_TILES m16 tiles, with the chunks of a plane
    balanced.  Its warps split K, each holding SLICE_STEPS k8 steps of the
    weight in registers.  Shared memory holds the input lines the chunk
    reads for each (ci, dz) (plus one zeroed run for K padding), the
    warps' partial sums for one n16 group, the address tables and the bias."""
    do, ho, wo = d - 2, h - 2, w - 2
    nchunks = _cdiv(ho * wo, 16 * MAX_TILES)
    rows = _cdiv(ho * wo, nchunks)
    mt = _cdiv(rows, 16)
    lines = (rows + wo - 2) // wo + 1    # y-lines `rows` rows span at most
    nslices = _cdiv(_cdiv(27 * ci, 8), SLICE_STEPS)
    ngroups = _cdiv(co, 16)
    ds = 4 * _cdiv((lines + 2) * w + 6, 4)   # run, widened to 16-byte bounds
    # Keep a k8 step that crosses from channel c's last taps to c+1's first
    # ones on other banks: (cs - offset of tap 24) = 16 (mod 32), to 4 words.
    cs = 3 * ds + (((16 + 2 * ds + 2 * w) & ~3) - 3 * ds) % 32
    rstride = 16 * mt + 4
    red_off = ci * cs + ds
    koff_off = red_off + WARPS * 16 * rstride
    rowoff_off = koff_off + nslices * SLICE_STEPS * 8   # koff is read as int2
    bias_off = rowoff_off + 16 * mt
    return Conv5Plan(ci, co, d, h, w, rows, nchunks, mt, nslices, ngroups, ds, cs,
                     rstride, red_off, koff_off, rowoff_off, bias_off,
                     4 * (bias_off + co), bsz * do * nchunks)


@functools.lru_cache(maxsize=64)
def _plan_words(shape) -> ctypes.Array:
    return (ctypes.c_int * len(Conv5Plan._fields))(*plan(*shape))


@functools.lru_cache(maxsize=None)
def _library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built kernel; ``defines`` selects an instrumented build
    (``ops/conv5_phases.py``)."""
    from .build import load

    lib = load("conv5", defines)
    lib.conv5_plan_ints.argtypes = []
    lib.conv5_plan_ints.restype = ctypes.c_int
    if lib.conv5_plan_ints() != len(Conv5Plan._fields):
        raise RuntimeError("conv5.cu's Plan does not match ops/conv5.py's Conv5Plan")
    for fn in (lib.conv5_fwd, lib.conv5_fwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def vector_staging(x) -> bool:
    """Whether the kernel stages x with 16-byte copies: every input z-slice
    starts on a 16-byte boundary."""
    return (x.shape[3] * x.shape[4]) % 4 == 0 and x.data_ptr() % 16 == 0


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
    if w.shape != (co, ci, 3, 3, 3) or b.shape != (co,):
        raise ValueError(f"conv5: w {tuple(w.shape)} / b {tuple(b.shape)} do "
                         f"not fit x with {ci} channels")
    if min(d, h, wd) < 3 or bsz < 1:
        raise ValueError(f"conv5: x {tuple(x.shape)} too small for a 3x3x3 VALID conv")
    if plan(bsz, ci, co, d, h, wd).smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv5: x {tuple(x.shape)} needs more shared memory "
                         "than one block has")
    dev = x.device
    if not x.is_cuda or w.device != dev or b.device != dev:
        raise ValueError("conv5: x, w and b must be CUDA tensors on x's device")


def _launch(lib, x, w, b, one_pass=False):
    """Launch `lib`'s kernel (its one-pass bfloat16 path if `one_pass`) on
    x's device and its current stream; returns y.
    The caller has checked the inputs.  The device context is entered only
    when x is not on the current device, and the stream is read as a raw
    pointer (no Stream object), to keep a call's host cost near the
    kernel's few microseconds."""
    bsz, ci, d, h, wd = x.shape
    co = w.shape[0]
    y = x.new_empty((bsz, co, d - 2, h - 2, wd - 2))
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            ctypes.addressof(_plan_words((bsz, ci, co, d, h, wd))), vector_staging(x))
    fwd = lib.conv5_fwd_bf16 if one_pass else lib.conv5_fwd
    dev = x.device.index
    if dev == torch.cuda.current_device():
        err = fwd(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fwd(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"conv5 kernel launch failed with CUDA error {err}")
    return y


def conv5_cuda(x, w, b, one_pass=False):
    """Launch the kernel on the current stream; returns y (B, Co, D-2, H-2, W-2).
    ``one_pass``: its bfloat16-operand path (launches counted the same)."""
    check_kernel_inputs(x, w, b)
    y = _launch(_library(), x, w, b, one_pass)
    if torch.cuda.is_current_stream_capturing():
        conv5.captured += 1
    else:
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


def conv5_plain_bf16(x, w, b):
    """Plain version of the one-pass path: the 27-tap sum on bfloat16-rounded
    operands (exact products, sums in x's dtype)."""
    return conv5_plain(round_bf16(x), round_bf16(w), b)


class _Conv5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, one_pass):
        ctx.one_pass = one_pass
        ctx.save_for_backward(x, w)
        if one_pass:
            products.SITES["forward"] += 1
        if x.is_cuda:
            return conv5_cuda(x, w, b, one_pass)   # the kernel rounds as it stages
        return (conv5_plain_bf16 if one_pass else conv5_plain)(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.one_pass:
            x, w, g_b, g = round_bf16(x), round_bf16(w), g, round_bf16(g)
            for kind, need in (("input_grad", 0), ("weight_grad", 1)):
                products.SITES[kind] += int(ctx.needs_input_grad[need])
        else:
            g_b = g
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_input(x.shape, w, g)
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight(x, w.shape, g)
        if ctx.needs_input_grad[2]:
            db = g_b.sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None


def conv5(x, w, b, one_pass=False):
    """Stride-1 VALID 3x3x3 conv plus bias: x (B,Ci,D,H,W), w (Co,Ci,3,3,3), b (Co,).
    ``one_pass``: the TPU's arithmetic (bfloat16 operands, fp32 sums),
    forward and backward."""
    return _Conv5.apply(x, w, b, one_pass)


conv5.launches = 0  # kernel launches, counted by conv5_cuda
conv5.captured = 0  # launches recorded into a CUDA graph under capture
