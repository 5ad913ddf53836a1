"""Dense causal attention with GQA (port of ray_tpu/ops/attention.py).

Materializes [B, H, Lq, Lk] scores: the reference the paged path is held
against in tests and in chip_smoke.py's dense re-forward, not a serving
path."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D], head h reading kv head h // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def causal_attention(
    q: torch.Tensor,  # [B, Lq, H, D]
    k: torch.Tensor,  # [B, Lk, Hkv, D]
    v: torch.Tensor,  # [B, Lk, Hkv, D]
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """q_offset: global position of q[0] relative to k[0]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        qpos = torch.arange(lq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
