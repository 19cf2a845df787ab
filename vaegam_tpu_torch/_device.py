"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller names another one.

    Never falls back to the CPU on its own: with no card and no explicit
    ``device="cpu"`` it raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def configure_cuda_backends() -> None:
    """Full-fp32 convs and matmuls on the card (TF32 off), and cuDNN's
    algorithm search on.

    cuDNN runs fp32 convolutions in TF32 by default, which keeps ~3 decimal
    digits and would drift the fp32 parity path toward its 1e-3 map bound.
    Without the algorithm search cuDNN's heuristic picks a direct
    weight-gradient kernel for the decoder's transposed convs that takes
    ~59 ms a call at batch 32 on an H100 (PERF.md); the search costs
    a few seconds at the first step of each shape.  The Trainer and
    chip_smoke.py call this once.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.benchmark = True
