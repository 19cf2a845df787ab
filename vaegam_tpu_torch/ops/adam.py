"""The train step's guarded Adam update, in place:
``apply_if_finite(chain(clip_by_global_norm?, adam(lr)))`` with optax's
defaults, as the JAX Trainer's optimizer.

  * ``adam_cuda``  -- the hand-written Hopper kernel (``csrc/adam.cu``),
    built at first use by ``ops.build``: two launches a step (a check that
    decides the step, and the update of every leaf), on the current
    stream, from a table of the leaves' addresses in the launch's
    parameters (:func:`pack`).  Counts its launches in ``adam.launches``,
    and a launch recorded into a CUDA graph, which runs only when the
    graph is replayed, in ``adam.captured``.
  * ``adam_plain`` -- the plain PyTorch version, ~22 ops a leaf.  The CPU
    path and the on-card comparison use it; the kernel gives its bits.
  * ``adam``       -- the op the Trainer calls: the kernel on CUDA tensors,
    the plain version on CPU tensors.

Every parameter, moment and counter keeps its storage (a captured step
reads and writes them at fixed addresses).  On a non-finite gradient no
parameter, moment or step count changes; ``notfinite_count``,
``last_finite`` and ``total_notfinite`` count it as optax does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam defaults (eps_root 0)
MAX_CONSECUTIVE_ERRORS = 100000  # as the JAX Trainer's apply_if_finite
COUNTERS = ("count", "notfinite_count", "last_finite", "total_notfinite")
_COUNTER_DTYPES = (torch.int32, torch.int32, torch.bool, torch.int32)

TILE = 4096          # csrc/adam.cu kTile: elements a tile, a block's unit of work
MAX_LEAVES = 80      # csrc/adam.cu kMaxLeaves: leaves the table takes (the model has 63)
MAX_BLOCKS = 1024    # csrc/adam.cu kMaxBlocks
WORK_BYTES = 16440   # sizeof(csrc/adam.cu Work)
DOUBLE, VEC = 1, 2   # csrc/adam.cu LeafFlags

# csrc/adam.cu's Leaf and Step, field by field (no padding: every field
# falls on its own alignment)
LEAF = np.dtype([("p", np.uint64), ("g", np.uint64), ("m", np.uint64), ("v", np.uint64),
                 ("n", np.int32), ("first_tile", np.int32), ("flags", np.int32),
                 ("pad", np.int32)])
STEP = np.dtype(
    [("leaf", LEAF, (MAX_LEAVES,))]
    + [(k, np.int32) for k in ("nleaves", "ntiles", "skip_nonfinite", "clip_on",
                               "any_double", "max_errors")]
    + [(k, np.float64) for k in ("one_minus_b1", "b1", "one_minus_b2", "b2", "eps",
                                 "neg_lr", "clip")]
    + [(k, np.uint64) for k in ("work",) + COUNTERS])


@torch.no_grad()
def adam_plain(params, grads, mu, nu, counters, lr, grad_clip=0.0,
               skip_nonfinite=True) -> None:
    """The update leaf by leaf in torch ops; ``counters`` maps
    :data:`COUNTERS` to 0-dim tensors."""
    st = counters
    if skip_nonfinite:
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    else:
        finite = torch.ones((), dtype=torch.bool, device=st["count"].device)
    notfinite_count = torch.where(finite, torch.zeros_like(st["notfinite_count"]),
                                  st["notfinite_count"] + 1)
    apply = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)
    if grad_clip and grad_clip > 0:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < grad_clip
        grads = [torch.where(trigger, g, (g / g_norm) * grad_clip)
                 for g in grads]
    count_inc = st["count"] + 1
    # bias corrections in each parameter's precision (a float64 epsilon
    # under x64_epsilon), as optax computes them
    bcs = {}
    for dt in {p.dtype for p in params}:
        c = count_inc.to(dt)
        bcs[dt] = (1.0 - torch.pow(torch.full_like(c, B1), c),
                   1.0 - torch.pow(torch.full_like(c, B2), c))
    for p, g, m, v in zip(params, grads, mu, nu):
        bc1, bc2 = bcs[p.dtype]
        m_new = (1 - B1) * g + B1 * m
        v_new = (1 - B2) * (g * g) + B2 * v
        upd = -lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS))
        p.copy_(torch.where(apply, p + upd, p))
        m.copy_(torch.where(apply, m_new, m))
        v.copy_(torch.where(apply, v_new, v))
    st["count"].copy_(torch.where(apply, count_inc, st["count"]))
    st["notfinite_count"].copy_(notfinite_count)
    st["last_finite"].copy_(finite)
    st["total_notfinite"].add_((~finite).to(torch.int32))


def workspace(device) -> torch.Tensor:
    """The kernel's device state for one optimizer (the check's partial
    sums and ticket, the step's decision), zeroed; its owner keeps it for
    the optimizer's life, at a fixed address."""
    return torch.zeros(WORK_BYTES, dtype=torch.uint8, device=device)


def pack(params, grads, mu, nu, counters, work, lr, grad_clip=0.0,
         skip_nonfinite=True) -> np.ndarray:
    """The kernel's launch parameters for one step, from the tensors of the
    call: a :data:`STEP` record.  Leaf i covers the tiles ``first_tile[i]``
    up to ``first_tile[i+1]``, TILE elements each (the last one ragged).
    Raises on leaves the kernel does not take: at most MAX_LEAVES, and p,
    g, m and v of a leaf sharing dtype (float32 or float64), size and
    device, and contiguous."""
    if not params or not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("adam: params, grads, mu and nu must be lists of one length")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"adam: {len(params)} leaves, the kernel takes {MAX_LEAVES}")
    dev = params[0].get_device()
    rows = []
    for leaf in zip(params, grads, mu, nu):
        n, dt = leaf[0].numel(), leaf[0].dtype
        if dt is not torch.float32 and dt is not torch.float64:
            raise TypeError(f"adam: a {dt} leaf (float32 and float64 only)")
        for t in leaf:
            if t.dtype is not dt or t.numel() != n or t.get_device() != dev:
                raise ValueError("adam: a leaf's p, g, m and v must share dtype, "
                                 "size and device")
            if not t.is_contiguous():
                raise ValueError("adam: p, g, m and v must be contiguous")
        rows.append((*(t.data_ptr() for t in leaf), n, dt is torch.float64))
    table = np.array(rows, np.uint64)
    ptrs, sizes, double = table[:, :4], table[:, 4].astype(np.int64), table[:, 5] == 1
    if sizes.max() > np.iinfo(np.int32).max - TILE:
        raise ValueError("adam: a leaf of 2**31 elements or more")
    tiles = -(-sizes // TILE)
    step = np.zeros((), STEP)
    leaf = step["leaf"][:len(rows)]
    for i, name in enumerate("pgmv"):
        leaf[name] = ptrs[:, i]
    leaf["n"] = sizes
    leaf["first_tile"] = np.cumsum(tiles) - tiles
    leaf["flags"] = DOUBLE * double + VEC * (ptrs % 16 == 0).all(axis=1)
    step["nleaves"], step["ntiles"] = len(rows), tiles.sum()
    step["skip_nonfinite"] = bool(skip_nonfinite)
    step["clip_on"] = bool(grad_clip and grad_clip > 0)
    step["any_double"] = bool(double.any())
    step["max_errors"] = MAX_CONSECUTIVE_ERRORS
    step["one_minus_b1"], step["b1"] = 1 - B1, B1
    step["one_minus_b2"], step["b2"] = 1 - B2, B2
    step["eps"], step["neg_lr"], step["clip"] = EPS, -lr, grad_clip or 0.0
    step["work"] = work.data_ptr()
    for name in COUNTERS:
        step[name] = counters[name].data_ptr()
    return step


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load

    lib = load("adam")
    for name, want in (("adam_step_bytes", STEP.itemsize), ("adam_work_bytes", WORK_BYTES),
                       ("adam_tile", TILE), ("adam_max_leaves", MAX_LEAVES),
                       ("adam_max_blocks", MAX_BLOCKS)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"adam.cu's {name} is {fn()}, ops/adam.py's {want}")
    lib.adam_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.adam_launch.restype = ctypes.c_int
    return lib


def adam_cuda(params, grads, mu, nu, counters, work, lr, grad_clip=0.0,
              skip_nonfinite=True) -> None:
    """Launch the kernel on the current stream: two launches.  Raises on
    what it does not take (:func:`pack` checks the leaves against the
    first): CPU tensors, counters or a workspace on another device or of
    another type."""
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError("adam: the kernel takes CUDA tensors")
    for name, dtype in zip(COUNTERS, _COUNTER_DTYPES):
        t = counters[name]
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"adam: counter {name} must be one {dtype} on {dev}")
    if work is None or work.device != dev or work.dtype != torch.uint8 or \
            work.numel() < WORK_BYTES:
        raise ValueError("adam: work must be ops.adam.workspace(device)")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    step = pack(params, grads, mu, nu, counters, work, lr, grad_clip, skip_nonfinite)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.adam_launch(step.ctypes.data, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed with CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        adam.captured += 2
    else:
        adam.launches += 2


def adam(params, grads, mu, nu, counters, work, lr, grad_clip=0.0,
         skip_nonfinite=True) -> None:
    """The guarded update of ``params`` and the moments ``mu``, ``nu``
    (lists of leaves) from ``grads``, in place: the kernel on CUDA leaves
    (``work`` from :func:`workspace`), the plain version on CPU ones."""
    if params[0].is_cuda:
        adam_cuda(params, grads, mu, nu, counters, work, lr, grad_clip, skip_nonfinite)
    else:
        adam_plain(params, grads, mu, nu, counters, lr, grad_clip, skip_nonfinite)


adam.launches = 0  # kernel launches, counted by adam_cuda
adam.captured = 0  # launches recorded into a CUDA graph under capture
