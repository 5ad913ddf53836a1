"""Rotary position embeddings, llama-style (port of ray_tpu/ops/rope.py)."""

from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """Returns (cos, sin) tables of shape [max_len, head_dim//2], f32."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [max_len, head_dim//2].

    positions: optional [..., seq] integer tensor of global positions.
    They are clamped into the table, as JAX's gather clamps them: padded
    prefill tokens and retired decode rows can sit at or past max_len, and
    their rows are masked downstream."""
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        idx = positions.long().clamp(0, cos.shape[0] - 1)
        c = cos[idx][..., :, None, :]
        s = sin[idx][..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope_bhsd(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Head-major variant: x [B, H, seq, head_dim]. As in JAX, computed
    in the INPUT dtype (tables cast to it, rotate-half as a roll with a
    sign mask), not in f32 as `apply_rope` does: bf16 rounds at the same
    places as the reference."""
    d = x.shape[-1]
    seq = x.shape[-2]
    c = torch.cat([cos[:seq], cos[:seq]], dim=-1)[None, None].to(x.dtype)
    s = torch.cat([sin[:seq], sin[:seq]], dim=-1)[None, None].to(x.dtype)
    sign = torch.cat([-torch.ones(d // 2, dtype=x.dtype, device=x.device),
                      torch.ones(d // 2, dtype=x.dtype, device=x.device)])
    rotated = torch.roll(x, d // 2, dims=-1) * sign
    return x * c + rotated * s
