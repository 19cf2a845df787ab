"""Per-layer benchmark of the decoder's stride-1 convs: ``F.conv3d`` against
the lane-packed conv (``ops.packed_conv``) at several pack factors.

Counterpart of ``vaegam_tpu.tools.bench_packed_conv``.  Each stride-1
decoder layer (convt1, convt3, convt5, as the convs they equal) runs at the
fused 9-way decode's batch (288 rows at batch 32), forward and
forward+backward, in fp32 and bf16, plain and at every pack of ``PACKS``
(or of ``--packs``).  Times are CUDA-event times over
``--iters`` back-to-back calls after two warm-up calls (cuDNN's algorithm
search runs in the first); on the CPU the host clock.  A pack that runs
out of memory is reported as such in the JSON line, and the run goes on.
The decision-grade number is the full step with ``VAEGAMConfig.conv_pack``
(``chip_smoke.py`` phase 10a), not this tool.

    python -m vaegam_tpu_torch.tools.bench_packed_conv [--batch 288] [--iters 30]
        [--packs 2x2 4x4]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from .._device import configure_cuda_backends, resolve_device
from ..ops.packed_conv import flop_inflation, packed_conv3d
from .common import emit, sync

# (name, input spatial, ic, oc, kernel, conv padding): the stride-1 decoder
# layers at the reference grid, as convs (a stride-1 transposed conv of
# padding 0 is a conv of padding k-1)
LAYERS = [
    ("convt1", (6, 8, 5), 16, 16, (3, 3, 3), ((2, 2), (2, 2), (2, 2))),
    ("convt3", (16, 21, 14), 16, 8, (3, 3, 3), ((2, 2), (2, 2), (2, 2))),
    ("convt5", (39, 47, 33), 8, 1, (3, 3, 3), ((2, 2), (2, 2), (2, 2))),
]
PACKS = [(2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 16)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def time_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean ms a call of fn() over `iters` back-to-back calls, after
    `warmup` calls (cuDNN's algorithm search runs in the first).  On the
    card the time is CUDA events around the chained calls; on the CPU the
    host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def _fwd_bwd(fwd, x, w):
    """forward, then the gradients of sum(y^2) (in fp32) wrt x and w."""
    y = fwd(x, w)
    return torch.autograd.grad(y.float().square().sum(), (x, w))


def _arm(fwd, x, w, device, iters):
    return {"fwd_ms": time_ms(lambda: fwd(x, w), device, iters),
            "fwd_bwd_ms": time_ms(lambda: _fwd_bwd(fwd, x, w), device, iters)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=288)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--packs", nargs="+", default=[f"{a}x{b}" for a, b in PACKS],
                    help="packs to time, as SHxSW (default: all of PACKS)")
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    packs = [tuple(int(v) for v in p.split("x")) for p in args.packs]
    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_cuda_backends()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    layers = []
    for name, spatial, ic, oc, k, pad in LAYERS:
        for dt_name, dtype in DTYPES.items():
            x = torch.randn((args.batch, ic, *spatial), generator=gen, device=device)
            w = torch.randn((oc, ic, *k), generator=gen, device=device)
            x, w = x.to(dtype).requires_grad_(True), w.to(dtype).requires_grad_(True)
            padding = tuple(lo for lo, _ in pad)

            def plain(x, w):
                return F.conv3d(x, w, padding=padding)

            out = [s + lo + hi - kk + 1 for s, (lo, hi), kk in zip(spatial, pad, k)]
            row = {"layer": name, "dtype": dt_name, "ic": ic, "oc": oc, "out": out,
                   "gflop": 2 * args.batch * int(np.prod(out)) * ic * int(np.prod(k)) * oc / 1e9,
                   "conv3d": _arm(plain, x, w, device, args.iters), "packs": {}}
            with torch.no_grad():
                want = plain(x, w).float()
            for pack in packs:
                key = f"{pack[0]}x{pack[1]}"

                def packed(x, w, _pack=pack):
                    return packed_conv3d(x, w, pad, _pack)

                try:
                    with torch.no_grad():
                        err = float((packed(x, w).float() - want).abs().max())
                    arm = _arm(packed, x, w, device, args.iters)
                except torch.cuda.OutOfMemoryError as e:
                    row["packs"][key] = {"error": f"OutOfMemoryError: {str(e)[:200]}"}
                    torch.cuda.empty_cache()
                    continue
                arm.update(
                    flop_inflation=flop_inflation(k[1], k[2], pack),
                    lanes=pack[0] * pack[1] * oc,
                    fwd_speedup=row["conv3d"]["fwd_ms"] / arm["fwd_ms"],
                    fwd_bwd_speedup=row["conv3d"]["fwd_bwd_ms"] / arm["fwd_bwd_ms"],
                    max_abs_err=err, max_abs_out=float(want.abs().max()))
                row["packs"][key] = arm
            layers.append(row)
            del x, w, want
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return emit({"tool": "bench_packed_conv", "device": name, "batch": args.batch,
                 "iters": args.iters, "layers": layers})


if __name__ == "__main__":
    main()
