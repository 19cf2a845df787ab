"""Where the conv5 kernel's time goes, block by block, on one NVIDIA GPU.

    python -m vaegam_tpu_torch.ops.conv5_phases [--shapes main mni]

Builds ``csrc/conv5.cu`` with ``-DCONV5_PHASE_CLOCKS`` (a separate library;
the kernel the port launches is built without it), launches it at each
shape, and prints from thread 0 of every block: the SM clock cycles of each
phase (issuing this warp's weight loads and the input copies; building the
address tables; splitting the weight fragments, which waits for their
loads; waiting for the copies; the product; the epilogue), median and max
over blocks; the spread of block start times and the kernel's span on the
global timer; and the blocks each SM ran.  Thread 0's clocks bound its
block's phases only at the barriers that close the wait and the product.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys

import numpy as np
import torch

from .conv5 import _launch, _library, check_kernel_inputs, plan

SHAPES = {"main": (32, 16, 8, 10, 6, 16), "mni": (4, 16, 20, 25, 20, 16)}
PHASES = ("issue B loads, copies", "tables", "split B (waits for B)", "wait for copies",
          "product", "epilogue")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv5_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = _library(("CONV5_PHASE_CLOCKS",))
    lib.conv5_clock_slots.argtypes = []
    lib.conv5_clock_slots.restype = ctypes.c_int
    lib.conv5_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.conv5_phase_clocks.restype = ctypes.c_int
    slots = lib.conv5_clock_slots()
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.shapes:
        bsz, ci, d, h, wd, co = SHAPES[name]
        x = torch.randn((bsz, ci, d, h, wd), generator=gen, device="cuda")
        w = torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda") * 0.05
        b = torch.randn((co,), generator=gen, device="cuda")
        check_kernel_inputs(x, w, b)
        p = plan(bsz, ci, co, d, h, wd)
        for _ in range(20):  # warm: the last launch's record is read
            _launch(lib, x, w, b)
        torch.cuda.synchronize()
        n = min(p.blocks, 4096)
        rec = (ctypes.c_longlong * (n * slots))()
        if lib.conv5_phase_clocks(ctypes.addressof(rec), n * slots):
            raise RuntimeError("reading the clock record failed")
        r = np.ctypeslib.as_array(rec).reshape(n, slots)
        print(f"conv5 {name} {tuple(x.shape)}: {p.blocks} blocks, {p.smem} B shared "
              f"memory, {p.mt} m16 tiles and {p.nslices} K slices a block")
        for i, label in enumerate(PHASES):
            cyc = r[:, i + 1] - r[:, i]
            print(f"  {label:22s} median {statistics.median(cyc):8.0f} cycles, "
                  f"max {cyc.max():8d}")
        tot = r[:, 6] - r[:, 0]
        print(f"  {'block total':22s} median {statistics.median(tot):8.0f} cycles, "
              f"max {tot.max():8d}")
        t0 = r[:, 7].min()
        print(f"  block start spread {(r[:, 7].max() - t0) / 1e3:.3f} us, kernel span "
              f"(first entry to last exit) {(r[:, 8].max() - t0) / 1e3:.3f} us, "
              f"block span median {statistics.median(r[:, 8] - r[:, 7]) / 1e3:.3f} us")
        per_sm = np.bincount(r[:, 9].astype(np.int64))
        print(f"  SMs used {np.count_nonzero(per_sm)}, blocks per SM "
              f"{sorted(set(per_sm[per_sm > 0].tolist()))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
