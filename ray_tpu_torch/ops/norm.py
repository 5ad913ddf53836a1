"""RMSNorm (port of ray_tpu/ops/norm.py): computed in f32 whatever the
input dtype, cast back on output."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(x.dtype)
