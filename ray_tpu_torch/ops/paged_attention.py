"""Multi-query paged attention over a block pool (port of
ray_tpu/ops/paged_attention.py).

Query i of slot b sits at global position positions[b] + i and attends
key position t iff t <= positions[b] + i and t < kv_len[b]. The keys and
values live in a pool of fixed-size blocks [N, block_tokens, KV, D]
addressed through a per-slot block table; the walk attends block in place
with an online softmax, so no gathered [B, Nmax * block_tokens] window
and no repeated KV heads ever exist. One function serves decode (Q = 1)
and prefill (Q = the bucketed suffix).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
`ray_tpu_torch/csrc/paged_attention.cu`, which replaces the Pallas TPU
kernel `_pa_kernel` (ray_tpu/ops/paged_attention.py:108). On a CPU tensor
it runs `_paged_attention_plain`, the same online-softmax walk in plain
PyTorch (the port of `_paged_attention_xla`); that is also the version
the kernel is held against on the card. There is no fallback from one to
the other: a CUDA tensor launches the kernel or raises.

What bounds the kernel on an H100: decode reads every live K/V byte once
per layer, sum_b live_blocks(b) * bt * KV * D * 2 * itemsize bytes, over
the memory bandwidth (3.35 TB/s on the SXM part); its 4 * Q * H * D
operations per live key are far below the tensor cores' rate. The kernel
reads each live block once per (slot, kv head, query tile) with 16-byte
loads and stops its walk at the first block past the live window; the
source's head comment says what it does not do yet.

Not ported yet: the int8 pool (k_scale/v_scale dequant in the kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

# last implementation that ran ("kernel" | "plain"): tests assert the path
# they meant to exercise actually ran
_LAST_IMPL: Optional[str] = None

_KERNEL_MAX_ROWS = 64  # query tile x GQA group rows one CTA holds
_KERNEL_BLOCK_Q = 16   # query tile, shrunk where the GQA group is wide


def _paged_attention_plain(q, k_pool, v_pool, ptable, positions, kv_len,
                           scale, partial_out, chunk_blocks):
    """The kernel's function in plain PyTorch: `chunk_blocks` physical
    blocks are gathered per step and folded into the online softmax."""
    b, Q, h, d = q.shape
    _, bt, kv, _ = k_pool.shape
    nmax = ptable.shape[1]
    n_rep = h // kv
    dev = q.device
    cb = max(1, min(chunk_blocks, nmax))
    nch = -(-nmax // cb)
    if nch * cb != nmax:
        ptable = torch.nn.functional.pad(ptable, (0, nch * cb - nmax), value=-1)
    qr = (q.float() * scale).reshape(b, Q, kv, n_rep, d)
    m = torch.full((b, Q, h, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, Q, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, Q, h, d), dtype=torch.float32, device=dev)
    qpos = positions.long()[:, None] + torch.arange(Q, device=dev)[None, :]
    kvl = kv_len.long()[:, None, None, None]
    for c in range(nch):
        tb = ptable[:, c * cb:(c + 1) * cb]  # [B, cb]
        idx = tb.clamp(min=0).long()
        kc = k_pool[idx].float().reshape(b, cb * bt, kv, d)
        vc = v_pool[idx].float().reshape(b, cb * bt, kv, d)
        s = torch.einsum("bqgnd,btgd->bqgnt", qr, kc).reshape(b, Q, h, cb * bt)
        kpos = c * cb * bt + torch.arange(cb * bt, device=dev)
        live = (tb >= 0).repeat_interleave(bt, dim=1)[:, None, None, :]
        mask = (
            live
            & (kpos[None, None, None, :] <= qpos[:, :, None, None])
            & (kpos[None, None, None, :] < kvl)
        )
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # NEG_INF is finite: a fully-masked row would otherwise see
        # exp(NEG_INF - NEG_INF) = 1 and sum garbage into l/acc
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum(
            "bqgnt,btgd->bqgnd", p.reshape(b, Q, kv, n_rep, cb * bt), vc
        ).reshape(b, Q, h, d)
        acc = acc * alpha + pv
        m = m_new
    if partial_out:
        return acc, m[..., 0], l[..., 0]
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l).to(q.dtype)


def _paged_attention_cuda(q, k_pool, v_pool, ptable, positions, kv_len,
                          scale, partial_out):
    """Launch the Hopper kernel on PyTorch's current stream. Checks what
    the kernel takes and raises on anything else."""
    from . import _kernels

    b, Q, h, d = q.shape
    _, bt, kv, _ = k_pool.shape
    nmax = ptable.shape[1]
    n_rep = h // kv
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention kernel takes bf16 or f32, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q and the K/V pools must share one dtype")
    if d not in (64, 128):
        raise ValueError(f"paged_attention kernel takes head_dim 64 or 128, got {d}")
    if n_rep > _KERNEL_MAX_ROWS:
        raise ValueError(f"GQA group of {n_rep} exceeds {_KERNEL_MAX_ROWS} rows")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("K/V pools must be contiguous")
    dev = q.device
    for t in (k_pool, v_pool, ptable, positions, kv_len):
        if t.device != dev:
            raise ValueError("every paged_attention operand must be on one device")
    q = q.contiguous()
    tables = ptable.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    for t in (q, k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention kernel needs 16-byte aligned q and pools")
    qb = max(1, min(_KERNEL_BLOCK_Q, Q, _KERNEL_MAX_ROWS // n_rep))
    if partial_out:
        out = None
        acc = torch.empty((b, Q, h, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, Q, h), dtype=torch.float32, device=dev)
        l = torch.empty((b, Q, h), dtype=torch.float32, device=dev)
    else:
        out = torch.empty_like(q)
        acc = m = l = None

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    lib = _kernels.load("paged_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(tables), ptr(positions),
            ptr(kv_len), ptr(out), ptr(acc), ptr(m), ptr(l),
            b, Q, h, kv, d, bt, nmax, qb, float(scale),
            int(q.dtype == torch.bfloat16), int(partial_out),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention.launches += 1
    if partial_out:
        return acc, m, l
    return out


def paged_attention(
    q: torch.Tensor,          # [B, H, D] one query per slot, or [B, Q, H, D]
    k_pool: torch.Tensor,     # [N, block_tokens, KV, D] physical blocks
    v_pool: torch.Tensor,     # [N, block_tokens, KV, D]
    tables: torch.Tensor,     # [B, Nmax] int block table per slot
    positions: torch.Tensor,  # [B] global position of query 0
    *,
    scale: Optional[float] = None,
    signed_tables: bool = False,  # True: entries < 0 are dead; False:
                                  # entry 0 is the null-block sentinel
    partial_out: bool = False,    # return (acc, m, l) for merge_partials
    chunk_blocks: int = 8,        # plain version: blocks per softmax step
    kv_len: Optional[torch.Tensor] = None,  # [B] live cached keys; keys at
                                  # kpos >= kv_len are dead (default
                                  # positions + Q: decode and prefill)
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns out in q's dtype and shape ([B, H, D] for 3-D q, else
    [B, Q, H, D]), or with `partial_out=True` the unnormalized f32
    (acc, m, l) triple (m/l drop the head_dim axis). Slots whose table is
    fully dead return zeros. CUDA tensors run the kernel and count one
    launch in `paged_attention.launches`; CPU tensors run the plain
    version."""
    global _LAST_IMPL
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    if q.shape[2] % k_pool.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k_pool.shape[2]}"
        )
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if signed_tables:
        ptable = tables.to(torch.int32)
    else:
        ptable = torch.where(tables > 0, tables, -1).to(torch.int32)
    positions = positions.to(torch.int32)
    if kv_len is None:
        kv_len = positions + q.shape[1]
    kv_len = kv_len.to(torch.int32)
    if q.is_cuda:
        _LAST_IMPL = "kernel"
        out = _paged_attention_cuda(
            q, k_pool, v_pool, ptable, positions, kv_len, scale, partial_out,
        )
    elif q.device.type == "cpu":
        _LAST_IMPL = "plain"
        out = _paged_attention_plain(
            q, k_pool, v_pool, ptable, positions, kv_len, scale, partial_out,
            chunk_blocks,
        )
    else:
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    if squeeze:
        if partial_out:
            acc, m, l = out
            return acc[:, 0], m[:, 0], l[:, 0]
        return out[:, 0]
    return out


paged_attention.launches = 0  # kernel launches; the plain version adds none


def merge_partials(acc, m, l, out_dtype=torch.float32):
    """Combine online-softmax partials carried along a leading dim:
    acc [S, ..., D] unnormalized, m/l [S, ...]. Rows with no live keys
    anywhere (l == 0 everywhere) come out zero, as from the kernel."""
    m_g = m.amax(dim=0)
    e = torch.exp(m - m_g)
    num = (acc * e[..., None]).sum(dim=0)
    den = (l * e).sum(dim=0)
    safe = torch.where(den == 0.0, 1.0, den)
    return (num / safe[..., None]).to(out_dtype)
