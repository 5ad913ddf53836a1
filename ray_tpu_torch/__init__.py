"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, slice by slice.

The JAX package `ray_tpu` stays the reference; this package mirrors its
module layout (`ops/`, `models/`, `serve/`, `train/`) so each port sits
beside the file it was ported from. It imports torch and never jax or
ray_tpu.

Entry points (`init_params`, `PagedDecodeEngine`, `entry.entry`,
`entry.train_bench`) run on the CUDA device unless the caller passes
`device="cpu"`, and raise RuntimeError when CUDA is absent; ops such as
`paged_attention` and `flash_attention` follow their tensors' device (a
CUDA tensor launches the kernel). Hand-written Hopper kernels
live under `csrc/` and are built with nvcc at first use
(`ops/_kernels.py`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises rather than
    quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
