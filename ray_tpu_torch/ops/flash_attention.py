"""FlashAttention forward and backward (port of
ray_tpu/ops/flash_attention.py).

Never materializes the [Lq, Lk] scores on the card: an online softmax
over kv tiles in the forward, and a FlashAttention-2 backward that
recomputes the probabilities from the saved log-sum-exp rows. GQA is
folded into the kernels (query head h reads kv head h // n_rep, and the
dK/dV group sum happens in the kernel's accumulators), so repeated K/V
heads are never made.

On CUDA tensors the wrapper launches the hand-written Hopper kernels of
`ray_tpu_torch/csrc/flash_attention.cu`, which replace the Pallas TPU
kernels `_fa_kernel` (B1, flash_attention.py:41), `_dq_kernel` (B2, :160),
`_dkv_kernel` (B3, :187) and `_dqkv_kernel` (B4, :228). On CPU tensors
it runs the plain versions below, which are also what the kernels are
held against on the card. A CUDA tensor launches the kernels or raises.

The block sizes choose the route as in JAX and nothing else (the CUDA
tiles are the kernels' own): the backward takes the fused kernel (B4)
iff the sequence is one block on each side (nq = nk = 1) and there is no
GQA group (n_rep = 1), else dq (B2) then dk/dv (B3). Sequences that the
blocks do not tile fall back to the dense functions of ops/attention.py.

What bounds the kernels on an H100: their products (2 * D operations per
visible query/key pair each; 2 in the forward, 3, 4 and 5 in the dq,
dk/dv and fused backward) over the tensor cores' rate, and for the
forward at D = 64 its bytes about as much. The source's head comment says
what the first version does about it and what it does not.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import _repeat_kv_bhsd, causal_attention, causal_attention_bhsd

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30

# what ran last, so tests can assert the path they meant to exercise:
# _LAST_IMPL is "kernel", "plain" or "dense" (the ragged fallback) and
# _LAST_ROUTE the backward's route, "fused" or "split"
_LAST_IMPL: Optional[str] = None
_LAST_ROUTE: Optional[str] = None


# --------------------------------------------------------------- plain


def _scores(q, k, scale, causal):
    """f32 scores [B, H, Lq, Lk] with k's heads repeated, and the mask."""
    kr = _repeat_kv_bhsd(k, q.shape[1] // k.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    lq, lk = q.shape[2], k.shape[2]
    if causal:
        mask = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
    else:
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    return torch.where(mask, s, NEG_INF), mask


def _flash_forward_plain(q, k, v, scale, causal):
    """The forward kernel's function from full f32 scores: returns out
    in q's dtype and lse [B, H, Lq] in f32, with p cast to v's dtype
    before P.V; a row with no visible key gives zeros and lse NEG_INF."""
    s, mask = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    vr = _repeat_kv_bhsd(v, q.shape[1] // v.shape[1])
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr.float())
    return (acc / safe_l).to(q.dtype), (m + torch.log(safe_l))[..., 0]


def _delta(out, do):
    """Delta_i = rowsum(dO * O) in f32, [B, H, Lq] (outside the kernels,
    as in JAX)."""
    return torch.einsum("bhld,bhld->bhl", do.float(), out.float())


def _flash_backward_plain(q, k, v, out, lse, do, scale, causal):
    """(dq, dk, dv) of the backward kernels from full f32 scores: p from
    lse, dS = p * (dP - Delta) * scale cast to k's dtype, dk/dv summed
    over the GQA group in f32. Both routes compute this one function."""
    n_rep = q.shape[1] // k.shape[1]
    s, mask = _scores(q, k, scale, causal)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    vr = _repeat_kv_bhsd(v, n_rep)
    kr = _repeat_kv_bhsd(k, n_rep)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vr.float())
    ds = (p * (dp - _delta(out, do)[..., None]) * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    b, kv, lk, d = k.shape
    dk = dk.reshape(b, kv, n_rep, lk, d).sum(dim=2)
    dv = dv.reshape(b, kv, n_rep, lk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- CUDA


def _check_cuda(same, stats=()):
    """`same`: q-like and k-like operands, one dtype; `stats`: f32 rows."""
    q = same[0]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention kernels take bf16 or f32, got {q.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"flash_attention kernels take head_dim 64 or 128, "
                         f"got {q.shape[-1]}")
    for t in (*same, *stats):
        if t.device != q.device:
            raise ValueError("every flash_attention operand must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernels need contiguous, "
                             "16-byte aligned operands")
    if any(t.dtype != q.dtype for t in same) or any(
            t.dtype != torch.float32 for t in stats):
        raise ValueError("q, k, v and dO must share one dtype; lse and "
                         "Delta are f32")


def _launch(fn, *args):
    from . import _kernels

    lib = _kernels.load("flash_attention")
    dev = args[0].device
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")


def _flash_forward_cuda(q, k, v, scale, causal):
    _check_cuda((q, k, v))
    b, h, lq, d = q.shape
    kv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", q, k, v, out, lse, b, h, kv, lq, lk, d,
            float(scale), int(causal), int(q.dtype == torch.bfloat16))
    flash_attention.launches["fwd"] += 1
    return out, lse


def _flash_backward_cuda(q, k, v, out, lse, do, scale, causal, fused):
    delta = _delta(out, do)
    _check_cuda((q, k, v, do), (lse, delta))
    b, h, lq, d = q.shape
    kv, lk = k.shape[1], k.shape[2]
    tail = (float(scale), int(causal), int(q.dtype == torch.bfloat16))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if fused:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        _launch("flash_dqkv_launch", q, k, v, do, lse, delta, dq_acc, dk, dv,
                b, h, lq, lk, d, *tail)
        flash_attention.launches["dqkv"] += 1
        return dq_acc.to(q.dtype), dk, dv
    dq = torch.empty_like(q)
    _launch("flash_dq_launch", q, k, v, do, lse, delta, dq, b, h, kv, lq, lk,
            d, *tail)
    flash_attention.launches["dq"] += 1
    _launch("flash_dkv_launch", q, k, v, do, lse, delta, dk, dv, b, h, kv, lq,
            lk, d, *tail)
    flash_attention.launches["dkv"] += 1
    return dq, dk, dv


# ------------------------------------------------------------ autograd


def _flash_forward(q, k, v, scale, causal):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU
    ones."""
    global _LAST_IMPL
    if q.is_cuda:
        _LAST_IMPL = "kernel"
        return _flash_forward_cuda(q, k, v, scale, causal)
    if q.device.type == "cpu":
        _LAST_IMPL = "plain"
        return _flash_forward_plain(q, k, v, scale, causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _flash_backward(q, k, v, out, lse, do, scale, causal, block_q, block_k):
    """(dq, dk, dv) by `_flash_backward`'s routing rule (:275)."""
    global _LAST_IMPL, _LAST_ROUTE
    fused = (q.shape[2] // block_q == 1 and k.shape[2] // block_k == 1
             and q.shape[1] == k.shape[1])
    _LAST_ROUTE = "fused" if fused else "split"
    if q.is_cuda:
        _LAST_IMPL = "kernel"
        return _flash_backward_cuda(q, k, v, out, lse, do, scale, causal, fused)
    if q.device.type == "cpu":
        _LAST_IMPL = "plain"
        return _flash_backward_plain(q, k, v, out, lse, do, scale, causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


class _Flash(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse) as `_flash_fwd`
    (:347) does, so backward never re-runs the forward kernel. The
    kernels write into tensors made here, which only this Function owns;
    nothing changes a saved tensor in place."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, block_q, block_k = ctx.args
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do.contiguous(), scale,
                                     causal, block_q, block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Lq, H, D]  (or [B, H, Lq, D] with layout="bhsd")
    k: torch.Tensor,  # [B, Lk, Hkv, D]
    v: torch.Tensor,  # [B, Lk, Hkv, D]
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    layout: str = "bshd",
) -> torch.Tensor:
    """Attention with the JAX signature (less `interpret`). The blocks are
    clamped to the sequence; a sequence they do not tile takes the dense
    path; q heads must be a multiple of kv heads. On CUDA tensors the
    forward counts one launch in `flash_attention.launches["fwd"]` and
    the backward one in "dqkv" (fused route) or one each in "dq" and
    "dkv" (split route)."""
    global _LAST_IMPL
    seq_axis = 2 if layout == "bhsd" else 1
    head_axis = 1 if layout == "bhsd" else 2
    block_q = min(block_q, q.shape[seq_axis])
    block_k = min(block_k, k.shape[seq_axis])
    if q.shape[seq_axis] % block_q or k.shape[seq_axis] % block_k:
        _LAST_IMPL = "dense"
        dense = causal_attention_bhsd if layout == "bhsd" else causal_attention
        return dense(q, k, v, scale=scale, causal=causal)
    if q.shape[head_axis] % k.shape[head_axis]:
        raise ValueError(
            f"q heads {q.shape[head_axis]} not a multiple of kv heads "
            f"{k.shape[head_axis]}"
        )
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if layout == "bhsd":
        return _Flash.apply(q, k, v, scale, causal, block_q, block_k)
    out = _Flash.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       scale, causal, block_q, block_k)
    return out.transpose(1, 2)


# kernel launches by kernel; the plain versions add none
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0, "dqkv": 0}
