"""The TPU's product arithmetic: bfloat16 operands, float32 sums.

The JAX package sets no matmul precision, so on a TPU XLA computes every
float32 ``dot_general`` and ``conv_general_dilated`` at DEFAULT precision:
one pass with both operands rounded to bfloat16 and the sums kept in
float32.  The transpose rules keep the primal's precision, so the backward
products round the cotangent and the saved operand the same way.  The
functions here compute each contraction so:

  * ``round_bf16`` rounds to nearest even at bfloat16 and returns the
    tensor's own dtype, bit for bit as ``jnp.asarray(v).astype(jnp.bfloat16)
    .astype(v.dtype)`` does (float64 goes through float32 on the way, as
    JAX's conversion does);
  * ``conv3d``, ``conv_transpose3d``, ``conv1d``, ``linear``, ``matmul``
    and ``einsum`` (two operands) are autograd Functions that round both
    operands of the forward product and of each backward product, then
    compute in the inputs' dtype: a product of two bfloat16 values is
    exact in float32, so only the sums' order differs from the TPU's.

A bias is added to the float32 (float64) result, and its gradient is the
unrounded cotangent's sum, as the JAX code's separate ``+ b`` is.  The
caller keeps TF32 off (``_device.configure_cuda_backends``), so that the
card's float32 products of bfloat16 values stay exact.

``ops(enabled)`` gives the set of operations a model calls: these (and
``relu``, below) when ``enabled``, torch's own otherwise.

``SITES`` counts the products by kind: ``forward``, ``input_grad`` (the
gradient of the first operand, from the cotangent and the second) and
``weight_grad`` (of the second, from the cotangent and the first), one a
call; a backward product that autograd does not need is not computed.
Launches recorded into a CUDA graph count once, at capture.
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import torch
import torch.nn.functional as F

SITES: Counter = Counter()
KINDS = ("forward", "input_grad", "weight_grad")


def reset_sites() -> None:
    SITES.clear()


def site_counts() -> dict:
    """{kind: count} for the three kinds, zeros included."""
    return {k: SITES[k] for k in KINDS}


# float64 magnitudes that JAX's conversion flushes to zero: those whose
# float32 rounding (24 bits, unbounded exponent) is below float32's smallest
# normal, the midpoint below it included
_F64_FLUSH_BELOW = torch.finfo(torch.float32).tiny * (1.0 - 2.0**-25)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at bfloat16, in t's own dtype.

    float32 rounds once.  float64 converts as JAX does: to float32 first,
    a result below float32's smallest normal flushed to a signed zero
    (XLA's flush-to-zero, tininess after rounding), then to bfloat16; so a
    value just above a bfloat16 tie can round down.  A bfloat16 or float16
    tensor is returned as it is.
    """
    if t.dtype in (torch.bfloat16, torch.float16):
        return t
    if t.dtype == torch.float64:
        f = t.float()
        f = torch.where(t.abs() < _F64_FLUSH_BELOW, torch.zeros_like(f).copysign(f), f)
        return f.to(torch.bfloat16).double()
    return t.to(torch.bfloat16).to(t.dtype)


def _count(ctx) -> None:
    if ctx.needs_input_grad[0]:
        SITES["input_grad"] += 1
    if ctx.needs_input_grad[1]:
        SITES["weight_grad"] += 1


class _Conv(torch.autograd.Function):
    """N-d convolution (or transposed convolution) through aten's
    ``convolution`` and ``convolution_backward`` on rounded operands."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, dilation, transposed, output_padding,
                groups):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, dilation, transposed, output_padding, groups)
        ctx.has_bias = bias is not None
        SITES["forward"] += 1
        return torch.ops.aten.convolution(xr, wr, bias, stride, padding, dilation,
                                          transposed, output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        stride, padding, dilation, transposed, output_padding, groups = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_x or need_w:
            _count(ctx)
            dx, dw, _ = torch.ops.aten.convolution_backward(
                round_bf16(g.contiguous()), xr, wr, None, stride, padding, dilation,
                transposed, output_padding, groups, [need_x, need_w, False])
        db = (g.sum(dim=[0, *range(2, g.dim())])
              if ctx.has_bias and ctx.needs_input_grad[2] else None)
        return dx, dw, db, None, None, None, None, None, None


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def conv3d(x, w, bias=None, stride=1, padding=0):
    """``F.conv3d(x, w, bias, stride, padding)`` on bfloat16-rounded operands."""
    return _Conv.apply(x, w, bias, _tuple(stride, 3), _tuple(padding, 3), (1, 1, 1),
                       False, (0, 0, 0), 1)


def conv_transpose3d(x, w, bias=None, stride=1, padding=0, output_padding=0):
    """``F.conv_transpose3d`` on bfloat16-rounded operands."""
    return _Conv.apply(x, w, bias, _tuple(stride, 3), _tuple(padding, 3), (1, 1, 1),
                       True, _tuple(output_padding, 3), 1)


def conv1d(x, w, bias=None):
    """``F.conv1d(x, w, bias)`` (stride 1, no padding) on rounded operands."""
    return _Conv.apply(x, w, bias, (1,), (0,), (1,), False, (0,), 1)


class _Linear(torch.autograd.Function):
    """x @ w.T + bias, w in ``nn.Linear``'s (out, in) layout."""

    @staticmethod
    def forward(ctx, x, w, bias):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = bias is not None
        SITES["forward"] += 1
        return F.linear(xr, wr, bias)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        _count(ctx)
        gr = round_bf16(g)
        dx = gr @ wr if ctx.needs_input_grad[0] else None
        dw = gr.mT @ xr if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def linear(x, w, bias=None):
    """``F.linear(x, w, bias)`` (x of shape (N, in)) on rounded operands."""
    return _Linear.apply(x, w, bias)


def _split(eq: str):
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return a, b, out


class _Einsum(torch.autograd.Function):
    """A two-operand einsum; each gradient is the einsum of the cotangent
    with the other operand, as JAX's dot_general transpose rules form it."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ar, br = round_bf16(a), round_bf16(b)
        sa, sb, so = _split(eq)
        for own, other in ((sa, sb), (sb, sa)):
            if not set(own.replace("...", "")) <= set(other + so):
                raise ValueError(f"einsum {eq}: an index of {own} is summed within "
                                 "it alone, which the backward does not form")
        ctx.save_for_backward(ar, br)
        ctx.subs = (sa, sb, so)
        SITES["forward"] += 1
        return torch.einsum(eq, ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        sa, sb, so = ctx.subs
        _, need_a, need_b = ctx.needs_input_grad
        gr = round_bf16(g)
        da = db = None
        if need_a:
            SITES["input_grad"] += 1
            da = torch.einsum(f"{so},{sb}->{sa}", gr, br)
        if need_b:
            SITES["weight_grad"] += 1
            db = torch.einsum(f"{sa},{so}->{sb}", ar, gr)
        return None, da, db


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` on rounded operands; every index must
    appear in two of the three subscripts."""
    return _Einsum.apply(eq, a, b)


def matmul(a, b):
    """``a @ b`` for stacks of matrices of the same batch shape (ranks >= 2)."""
    if a.dim() != b.dim() or a.dim() < 2:
        raise ValueError(f"matmul: ranks {a.dim()} and {b.dim()}: equal, >= 2")
    return einsum("...ij,...jk->...ik", a, b)


def relu(x):
    """``jnp.maximum(x, 0)``, the JAX networks' relu: its gradient at an
    exact zero is 1/2 (``F.relu``'s is 0).  Rounded operands make a conv's
    sums cancel to exact zeros now and then, where the two rules part."""
    return torch.maximum(x, x.new_zeros(()))


# the operations of a model's step, in the TPU's arithmetic or in torch's
TPU = SimpleNamespace(conv3d=conv3d, conv_transpose3d=conv_transpose3d, conv1d=conv1d,
                      linear=linear, einsum=einsum, matmul=matmul, relu=relu)
TORCH = SimpleNamespace(conv3d=F.conv3d, conv_transpose3d=F.conv_transpose3d,
                        conv1d=F.conv1d, linear=F.linear, einsum=torch.einsum,
                        matmul=torch.matmul, relu=F.relu)


def ops(enabled: bool) -> SimpleNamespace:
    """``TPU`` if enabled (``VAEGAMConfig.tpu_products``), else ``TORCH``."""
    return TPU if enabled else TORCH
