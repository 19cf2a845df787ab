"""Decoder convt5: the stride-1, padding-0, 3x3x3 transposed conv from Ci
channels to 1, with bias, fp32, NCDHW (``F.conv_transpose3d`` with a
(Ci, 1, 3, 3, 3) weight).  The JAX package leaves it to XLA; the port runs
it as a hand-written kernel because cuDNN serves this shape far from its
bytes bound (``csrc/convt5.cu`` says what bounds it).

  * ``convt5_cuda`` / ``convt5_grads_cuda`` -- the kernels
    (``csrc/convt5.cu``), built at first use by ``ops.build``: one launch
    forward, two for the gradients (a fused pass that writes gx and each
    block's partial sums of gw and gb, and a reduction of the partials in
    float64 in a fixed order, so two runs give the same bits).  They count
    their launches in ``convt5.launches``, and a launch recorded into a CUDA
    graph, which runs only when the graph is replayed, in
    ``convt5.captured``.
  * ``convt5_plain`` / ``convt5_plain_grads`` -- the plain PyTorch versions:
    27-tap shifted-slice sums, the taps of a chunk of rows in one matmul.
    The CPU path and the on-card comparison use them.
  * ``convt5`` -- the op the decoder calls: an autograd Function that saves
    what the stock op saves (x and w) and takes the kernels on CUDA tensors
    and the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

MAX_SMEM_BYTES = 232448      # largest dynamic shared memory a Hopper block may opt into
WIDTHS = (7, 8)              # csrc/convt5.cu kXs: the chunk widths it is built for
MAX_THREADS = 256            # csrc/convt5.cu kMaxThreads
STAGES = 2                   # csrc/convt5.cu kStages: planes a block stages at once
FWD_THREADS = (256, 192, 128, 96, 64)  # threads a forward block: the first that gives
MIN_BLOCKS = 4 * 132         # this many blocks (four an SM of an H100), else the last
BWD_THREADS = 128            # threads a backward block, as near as the rows allow
FWD_SMEM = 56000             # forward shared memory bytes a block at most, where a channel
                             # group fits: four blocks an SM
TAPS = tuple(itertools.product(range(3), repeat=3))   # (dz, dy, dx), the weight's order
PLAIN_WORDS = 1 << 26        # the plain version's stacked tap copies, elements at most


class Convt5Plan(NamedTuple):
    """How csrc/convt5.cu tiles one input shape: the kernels read these ints
    in this order (its ``struct Plan``).  Strides and sizes are in 4-byte
    words of dynamic shared memory."""

    b: int
    ci: int
    d: int
    h: int
    w: int
    fx: int          # forward: output columns a thread
    fnch: int        # chunks of fx covering W + 2
    fty: int         # output rows a block
    fnty: int        # blocks a row n
    fthreads: int
    frs: int         # padded row stride of a staged x channel (odd)
    fcs: int         # words a staged x channel: fty + 2 rows
    fcg: int         # channels a stage buffer holds: a divisor of Ci
    fos: int         # words of the output band
    fsmem: int       # bytes of dynamic shared memory
    fblocks: int
    bx: int          # backward: x columns a thread
    bnch: int        # chunks of bx covering W
    bty: int         # x rows a block
    bnty: int        # blocks a row n
    bthreads: int    # Ci * bty * bnch
    brsg: int        # padded row stride of the staged gy plane (odd)
    brsx: int        # padded row stride of a staged x channel (odd)
    bgsz: int        # words a staged gy plane: bty + 2 rows
    bxs: int         # words a staged x channel: bty rows (4 mod 32, spreading channels over banks)
    bgxs: int        # words a gx band channel: bty rows of W
    bsmem: int
    bblocks: int
    nparts: int      # partial-sum columns: Ci * 27 weights and the bias


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return 4 * _cdiv(n, 4)


def _odd(n: int) -> int:
    return n | 1


def _rows(nrows: int, per_row: int, target: int) -> tuple:
    """(rows a block, blocks) splitting `nrows` rows into near-equal bands of
    about `target` threads at `per_row` threads a row."""
    nbands = _cdiv(nrows, max(1, target // per_row))
    rows = _cdiv(nrows, nbands)
    return rows, _cdiv(nrows, rows)


def _tiling(cols: int, nrows: int, channels: int, target: int) -> tuple:
    """(X, chunks, rows a block, blocks) for `nrows` rows of `cols`
    columns, a thread for each chunk of X columns of a row (times
    `channels`): the width whose blocks launch the fewest lanes times X,
    padding columns and the idle lanes of a block's last warp included
    (ties: the narrower chunk, fewer registers)."""
    def cost(x):
        nch = _cdiv(cols, x)
        rows, blocks = _rows(nrows, channels * nch, target)
        return blocks * 32 * _cdiv(channels * nch * rows, 32) * x, x

    x = min(WIDTHS, key=cost)
    nch = _cdiv(cols, x)
    return (x, nch, *_rows(nrows, channels * nch, target))


@functools.lru_cache(maxsize=64)
def plan(b: int, ci: int, d: int, h: int, w: int) -> Convt5Plan:
    """Tile an input (b, ci, d, h, w) for the kernels.

    A block owns one row n and a band of rows of the plane at full width
    and marches through z; a thread owns a chunk of consecutive columns of
    one row (the forward: of the output, all channels; the backward: of the
    input, one channel).  Staged rows are padded with zero columns (2 on the
    left in the forward, the chunks' overhang on the right)."""
    hy, wx = h + 2, w + 2
    for target in FWD_THREADS:
        fx, fnch, fty, fnty = _tiling(wx, hy, 1, target)
        if b * fnty >= MIN_BLOCKS:
            break
    frs = _odd(fnch * fx + 2)
    fcs = _round4((fty + 2) * frs)
    fos = _round4(fty * wx)

    def fsmem_of(cg):  # stage buffers, weights, two output bands, the rows' table (12 B a row)
        return 4 * (STAGES * cg * fcs + 28 * ci + 2 * fos) + 12 * cg * (fty + 2)

    fcg = next((g for g in range(ci, 0, -1) if ci % g == 0 and fsmem_of(g) <= FWD_SMEM), 1)
    fsmem = fsmem_of(fcg)
    bx, bnch, bty, bnty = _tiling(w, h, ci, BWD_THREADS)
    bthreads = ci * bty * bnch
    brsg = _odd(bnch * bx + 2)
    brsx = _odd(bnch * bx)
    bgsz = _round4((bty + 2) * brsg)
    bxs = bty * brsx + (4 - bty * brsx) % 32
    bgxs = _round4(bty * w)
    # stage buffers, two gx bands, the weights, the x rows' table (16 B a
    # row); after the march, 30 words a thread
    bsmem = max(4 * (STAGES * (bgsz + ci * bxs) + 2 * ci * bgxs + 28 * ci) + 16 * ci * bty,
                4 * 30 * bthreads)
    return Convt5Plan(b, ci, d, h, w, fx, fnch, fty, fnty, fty * fnch, frs, fcs, fcg, fos, fsmem,
                      b * fnty, bx, bnch, bty, bnty, bthreads, brsg, brsx, bgsz, bxs, bgxs,
                      bsmem, b * bnty, 27 * ci + 1)


@functools.lru_cache(maxsize=64)
def _plan_words(shape) -> ctypes.Array:
    return (ctypes.c_int * len(Convt5Plan._fields))(*plan(*shape))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels, checked against this module's plan layout."""
    from .build import load

    lib = load("convt5")
    for fn in (lib.convt5_plan_ints, lib.convt5_stages):
        fn.argtypes, fn.restype = [], ctypes.c_int
    if lib.convt5_plan_ints() != len(Convt5Plan._fields):
        raise RuntimeError("convt5.cu's Plan does not match ops/convt5.py's Convt5Plan")
    if lib.convt5_stages() != STAGES:
        raise RuntimeError("convt5.cu's kStages does not match ops/convt5.py's STAGES")
    widths = (ctypes.c_int * 16)()
    lib.convt5_widths.argtypes = [ctypes.c_void_p]
    lib.convt5_widths.restype = ctypes.c_int
    if tuple(widths[:lib.convt5_widths(widths)]) != WIDTHS:
        raise RuntimeError("convt5.cu's chunk widths do not match ops/convt5.py's WIDTHS")
    lib.convt5_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    lib.convt5_forward.restype = ctypes.c_int
    lib.convt5_backward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    lib.convt5_backward.restype = ctypes.c_int
    return lib


def check_kernel_inputs(x, w, b=None) -> None:
    """Raise on anything the kernels do not take (``b`` None: the
    gradients' inputs x and w)."""
    named = (("x", x), ("w", w)) + ((("b", b),) if b is not None else ())
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"convt5: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"convt5: {name} must be contiguous")
    if x.dim() != 5 or min(x.shape) < 1:
        raise ValueError(f"convt5: x must be a non-empty (B, Ci, D, H, W), got {tuple(x.shape)}")
    ci = x.shape[1]
    if w.shape != (ci, 1, 3, 3, 3) or (b is not None and b.shape != (1,)):
        raise ValueError(f"convt5: w {tuple(w.shape)} / b {None if b is None else tuple(b.shape)}"
                         f" do not fit x with {ci} channels (w (Ci, 1, 3, 3, 3), b (1,))")
    p = plan(*x.shape)
    if max(p.fthreads, p.bthreads) > MAX_THREADS or max(p.fsmem, p.bsmem) > MAX_SMEM_BYTES:
        raise ValueError(f"convt5: x {tuple(x.shape)} needs more threads or shared memory "
                         "than one block has")
    dev = x.device
    if not x.is_cuda or any(t.device != dev for _, t in named):
        raise ValueError("convt5: x, w and b must be CUDA tensors on x's device")


def _count(n: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        convt5.captured += n
    else:
        convt5.launches += n


def _call(fn, dev: int, *args) -> None:
    """Call a launcher on device `dev`'s current stream; raise on its error.
    The device context is entered only when `dev` is not current."""
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"convt5 kernel launch failed with CUDA error {err}")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def convt5_cuda(x, w, b):
    """The forward kernel on the current stream; returns y (B, 1, D+2, H+2, W+2)."""
    check_kernel_inputs(x, w, b)
    bsz, _, d, h, wd = x.shape
    y = x.new_empty((bsz, 1, d + 2, h + 2, wd + 2))
    _call(_library().convt5_forward, x.device.index, x.data_ptr(), w.data_ptr(),
          b.data_ptr(), y.data_ptr(), ctypes.addressof(_plan_words(tuple(x.shape))),
          (wd + 2) % 4 == 0 and _aligned(y))
    _count(1)
    return y


def convt5_grads_cuda(x, w, gy):
    """The gradients' two kernels on the current stream; returns (gx, gw, gb)."""
    bsz, ci, d, h, wd = x.shape
    if gy.shape != (bsz, 1, d + 2, h + 2, wd + 2) or gy.dtype != torch.float32 or \
            not gy.is_contiguous() or gy.device != x.device:
        raise ValueError(f"convt5: gy {tuple(gy.shape)} ({gy.dtype}) must be a contiguous "
                         f"float32 (B, 1, D+2, H+2, W+2) on x's device for x {tuple(x.shape)}")
    check_kernel_inputs(x, w)
    p = plan(*x.shape)
    gx = torch.empty_like(x)
    gw = torch.empty_like(w)
    gb = w.new_empty(1)
    part = torch.empty((p.nparts, p.bblocks), dtype=torch.float64, device=x.device)
    _call(_library().convt5_backward, x.device.index, gy.data_ptr(), x.data_ptr(),
          w.data_ptr(), gx.data_ptr(), part.data_ptr(), gw.data_ptr(), gb.data_ptr(),
          ctypes.addressof(_plan_words(tuple(x.shape))), wd % 4 == 0 and _aligned(gx))
    _count(2)
    return gx, gw, gb


def _row_chunks(bsz: int, row_words: int):
    """Slices of the batch rows that keep 27 shifted copies of a chunk's
    output within PLAIN_WORDS elements."""
    n = max(1, PLAIN_WORDS // (27 * row_words))
    return [slice(r, min(r + n, bsz)) for r in range(0, bsz, n)]


def convt5_plain(x, w, b):
    """Plain PyTorch forward: tap (dz, dy, dx) adds w[:, 0, dz, dy, dx] . x
    into y shifted by (dz, dy, dx); one matmul gives a chunk of rows' 27 tap
    products."""
    bsz, ci, d, h, wd = x.shape
    y = x.new_zeros((bsz, 1, d + 2, h + 2, wd + 2))
    wt = w.reshape(ci, 27).t()
    for rows in _row_chunks(bsz, y[0].numel()):
        t = torch.matmul(wt, x[rows].reshape(-1, ci, d * h * wd)).view(-1, 27, d, h, wd)
        for k, (dz, dy, dx) in enumerate(TAPS):
            y[rows, 0, dz:dz + d, dy:dy + h, dx:dx + wd] += t[:, k]
    return y + b.reshape(1, 1, 1, 1, 1)


def convt5_plain_grads(x, w, gy):
    """Plain PyTorch gradients (gx, gw, gb) of convt5_plain's output against
    the cotangent gy: a chunk of rows' 27 shifted slices of gy, stacked,
    contract with w into gx and with x into gw."""
    bsz, ci, d, h, wd = x.shape
    gx = torch.empty_like(x)
    gw = x.new_zeros((ci, 27))
    wc = w.reshape(ci, 27)
    for rows in _row_chunks(bsz, gy[0].numel()):
        g = torch.stack([gy[rows, 0, dz:dz + d, dy:dy + h, dx:dx + wd] for dz, dy, dx in TAPS],
                        1).reshape(-1, 27, d * h * wd)
        gx[rows] = torch.matmul(wc, g).view(-1, ci, d, h, wd)
        gw += torch.matmul(x[rows].reshape(-1, ci, d * h * wd), g.transpose(1, 2)).sum(0)
    return gx, gw.reshape(w.shape), gy.sum(dim=(0, 2, 3, 4))


class _Convt5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return convt5_cuda(x, w, b)
        return convt5_plain(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        grads = convt5_grads_cuda if gy.is_cuda else convt5_plain_grads
        return grads(x, w, gy.contiguous())


def convt5(x, w, b):
    """conv_transpose3d(x, w, b) for x (B, Ci, D, H, W), w (Ci, 1, 3, 3, 3),
    b (1,): y (B, 1, D+2, H+2, W+2)."""
    return _Convt5.apply(x, w, b)


convt5.launches = 0  # kernel launches, counted by convt5_cuda and convt5_grads_cuda
convt5.captured = 0  # launches recorded into a CUDA graph under capture
