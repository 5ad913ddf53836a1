"""Decoder-only transformer LM, llama-family (port of the serving and
single-device training halves of ray_tpu/models/transformer.py).

Parameters are a plain dict with the JAX tree's keys and shapes: every
layer leaf is stacked along a leading [n_layers] dim, so a JAX tree
converted leaf by leaf (`ray_tpu_torch.weights.params_from_numpy`) is a
valid port tree. Matmul weights compute in `cfg.dtype`; norm scales stay
f32 (rms_norm computes in f32 anyway).

Serving runs through `make_paged_decoder`: a pool of fixed-size KV blocks
shared by all decode slots through per-slot block tables, attended in
place by `ops.paged_attention` (the Hopper kernel on the card). Host-side
allocation, prefix reuse and preemption live in models/kv_paging.py.

Training runs through `make_forward` / `make_loss_fn` on the head-major
dense and flash routes (`ops.flash_attention`, the Hopper kernels on the
card), with the remat policies "full", "flash_min" and "flash_qkv" as
checkpointed segments; train/step.py adds the optimizer and the step.

Not ported yet: MoE, ring/ulysses attention, pipeline stages, the remat
policies "dots", "dots_no_batch" and "flash", the dense decoder, the
gather attention path, the int8 pool and speculative verify.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.attention import NEG_INF, causal_attention_bhsd
from ..ops.flash_attention import flash_attention
from ..ops.losses import (
    blockwise_softmax_cross_entropy,
    softmax_cross_entropy_with_int_labels,
)
from ..ops.norm import rms_norm
from ..ops.paged_attention import paged_attention
from ..ops.rope import apply_rope, apply_rope_bhsd, rope_frequencies


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12
    d_head: int = 64
    d_ff: int = 3072
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # "silu_gate": llama-family gated MLP (w_gate/w_up/w_down, silu).
    # "gelu": gpt2-family two-matmul MLP (w_up/w_down, tanh-approx gelu)
    mlp_variant: str = "silu_gate"
    # trailing vocab entries that exist only for alignment: the sampler
    # masks their logits so a padded id is never emitted
    vocab_pad: int = 0
    # training forward: "dense" | "flash" (the Hopper kernels of
    # ops/flash_attention.py); "ring" and "ulysses" are not ported yet
    attention: str = "dense"
    # per-layer rematerialization; see make_forward for what each policy
    # keeps for the backward
    remat: bool = True
    remat_policy: str = "full"
    # flash blocks: they choose the backward's route as in JAX (fused iff
    # the sequence is one block and there is no GQA group), not the CUDA
    # kernels' tiles
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    # accepted for the JAX configs' sake and ignored: the port always runs
    # its layers as a Python loop
    scan_layers: bool = True
    # >0: the training loss projects and normalizes the logits in sequence
    # chunks of this size (ops/losses.py blockwise_softmax_cross_entropy)
    loss_chunk: int = 0

    def __post_init__(self):
        if self.mlp_variant not in ("silu_gate", "gelu"):
            raise ValueError(
                f"mlp_variant must be 'silu_gate' or 'gelu', "
                f"got {self.mlp_variant!r}"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not a multiple of "
                f"n_kv_heads {self.n_kv_heads}"
            )

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~ 3x the forward's
        weight matmuls), as JAX's `flops_per_token`."""
        attn = 2 * self.d_model * self.d_head * (self.n_heads + 2 * self.n_kv_heads)
        attn += 2 * self.n_heads * self.d_head * self.d_model
        n_mats = 2 if self.mlp_variant == "gelu" else 3
        mlp = n_mats * 2 * self.d_model * self.d_ff
        embed = 2 * self.d_model * self.vocab_size
        return 3 * (self.n_layers * (attn + mlp) + embed)

    def attention_flops_per_token(self, seq_len: int) -> float:
        """Scores and values over the full seq_len (no causal halving),
        fwd+bwd, as JAX counts them."""
        return 3 * self.n_layers * (2 * 2 * seq_len * self.n_heads * self.d_head)

    def num_params(self) -> int:
        lp = (
            2 * self.d_model  # norms
            + self.d_model * self.d_head * (self.n_heads + 2 * self.n_kv_heads)
            + self.n_heads * self.d_head * self.d_model
            + (2 if self.mlp_variant == "gelu" else 3) * self.d_model * self.d_ff
        )
        total = self.n_layers * lp + self.d_model
        total += self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return total


CONFIGS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, max_seq_len=128,
    ),
    "gpt2_125m": TransformerConfig(
        vocab_size=50304, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=3072, max_seq_len=1024,
    ),
    "gpt_1b": TransformerConfig(
        vocab_size=50304, d_model=2048, n_layers=14, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=8192, max_seq_len=1024, loss_chunk=256,
    ),
    "llama2_7b": TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        d_head=128, d_ff=11008, max_seq_len=4096,
    ),
    # Llama-3-8B-style GQA config
    "llama3_8b": TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
    ),
}


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, in the JAX tree's keys and layout."""
    L, E, H, KV, D, F = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
    )
    layer = {
        "attn_norm": (L, E),
        "wq": (L, E, H, D),
        "wk": (L, E, KV, D),
        "wv": (L, E, KV, D),
        "wo": (L, H, D, E),
        "mlp_norm": (L, E),
    }
    if cfg.mlp_variant == "gelu":
        layer.update(w_up=(L, E, F), w_down=(L, F, E))
    else:
        layer.update(w_gate=(L, E, F), w_up=(L, E, F), w_down=(L, F, E))
    shapes = {"embed": (cfg.vocab_size, E), "layers": layer, "final_norm": (E,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (E, cfg.vocab_size)
    return shapes


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                *, device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters made on `device` (CUDA unless named) from
    `generator` (seed 0 when None), with the JAX init's scales: matmul
    weights N(0, 1/fan_in), embed N(0, 0.02^2), norm scales 1. Matmul
    weights and embeddings are made in `dtype` (f32 masters as in JAX by
    default; a serving caller asks for the compute dtype directly); norm
    scales are always f32."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    shapes = param_shapes(cfg)
    fan_in = {
        "wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
        "wo": cfg.n_heads * cfg.d_head, "w_gate": cfg.d_model,
        "w_up": cfg.d_model, "w_down": cfg.d_ff,
    }

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(std)

    layer = {}
    for key, shape in shapes["layers"].items():
        if key.endswith("_norm"):
            layer[key] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            layer[key] = normal(shape, 1.0 / math.sqrt(fan_in[key]))
    params = {
        "embed": normal(shapes["embed"], 0.02),
        "layers": layer,
        "final_norm": torch.ones(shapes["final_norm"], dtype=torch.float32,
                                 device=dev),
    }
    if "unembed" in shapes:
        params["unembed"] = normal(shapes["unembed"], 1.0 / math.sqrt(cfg.d_model))
    return params


# --------------------------------------------------------------------------
# forward pieces
# --------------------------------------------------------------------------


_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _cast_matmul_params(cfg: TransformerConfig, params):
    """The matmul weights in compute dtype (no copy where they already
    are); norm scales stay f32."""
    layers = dict(params["layers"])
    for key in _MATMUL_KEYS:
        if key in layers:
            layers[key] = layers[key].to(cfg.dtype)
    return {**params, "layers": layers}


def _mlp(h, lp, cfg: TransformerConfig):
    """Dense MLP of one layer: h [B, S, E] with lp's unstacked weights."""
    u = torch.einsum("bse,ef->bsf", h, lp["w_up"].to(h.dtype))
    if cfg.mlp_variant == "gelu":
        return torch.einsum(
            "bsf,fe->bse", torch.nn.functional.gelu(u, approximate="tanh"),
            lp["w_down"].to(h.dtype),
        )
    g = torch.einsum("bse,ef->bsf", h, lp["w_gate"].to(h.dtype))
    return torch.einsum(
        "bsf,fe->bse", torch.nn.functional.silu(g) * u, lp["w_down"].to(h.dtype)
    )


def _make_sampler(temperature: float, vocab_pad: int = 0):
    """Greedy argmax (temperature 0) or categorical sampling from a
    `torch.Generator`. `vocab_pad` masks the trailing alignment-only
    vocab entries so a padded id can never be emitted."""

    def _sample(logits, generator=None):
        if vocab_pad:
            V = logits.shape[-1]
            pad = torch.arange(V, device=logits.device) >= V - vocab_pad
            logits = torch.where(pad, NEG_INF, logits)
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return _sample


def _unembed_matrix(cfg: TransformerConfig, params):
    u = params.get("unembed")
    if u is None:
        u = params["embed"].T
    return u.to(cfg.dtype)


# --------------------------------------------------------------------------
# training forward and loss
# --------------------------------------------------------------------------

_REMAT_POLICIES = ("full", "flash_min", "flash_qkv")
_REMAT_NOT_PORTED = ("dots", "dots_no_batch", "flash")


def _checkpoint(fn, *args):
    """fn(*args) under a non-reentrant checkpoint: only the arguments are
    kept, the rest is recomputed in backward. Without grad there is
    nothing to keep and fn just runs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def make_forward(cfg: TransformerConfig, _return_backbone: bool = False):
    """Build forward(params, tokens[B, S]) -> logits [B, S, V] on the
    head-major ([B, H, S, D]) routes of JAX's `make_forward` (:420):
    `attention="dense"` (ops.attention.causal_attention_bhsd) and
    `attention="flash"` (ops.flash_attention, the Hopper kernels on the
    card, blocks clamped to the sequence).

    Remat. `torch.utils.checkpoint` cannot choose what to save inside a
    kernel launched through ctypes, so each layer is cut into segments
    whose boundaries are exactly the residuals the JAX policy names:

      1. norm -> q/k/v projections -> rope, ending at rope_q, rope_k and
         attn_v;
      2. attention: flash is its own autograd Function, whose ctx keeps
         (q, k, v, out, lse) (flash_out and flash_lse); dense attention is
         recomputed;
      3. wo + residual + norm + gate/up, ending at mlp_gate and mlp_up;
      4. the down projection.

    Each segment runs under a checkpoint, so it keeps only its inputs.
    "flash_min" keeps everything named above and never re-runs the
    forward kernel in backward; "flash_qkv" merges segments 3 and 4, so
    gate/up are recomputed; "full" checkpoints the whole layer (backward
    re-runs it, forward kernel included); remat=False keeps everything.
    "dots", "dots_no_batch" and "flash" are not ported yet and raise.

    With `_return_backbone` returns (forward, backbone), backbone(params,
    tokens) -> (final-norm hidden states, unembed in cfg.dtype)."""
    if cfg.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} is sequence-parallel and not ported "
            f"yet (ROADMAP A, slice 4)"
        )
    if cfg.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    policy = cfg.remat_policy if cfg.remat else None
    if policy in _REMAT_NOT_PORTED:
        raise NotImplementedError(
            f"remat_policy={policy!r} is not ported yet (ROADMAP A, slice 2); "
            f"the port has {_REMAT_POLICIES} and remat=False"
        )
    if policy is not None and policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    gelu = cfg.mlp_variant == "gelu"
    rope_tables: Dict[torch.device, Any] = {}

    def attend(q, k, v):
        if cfg.attention == "flash":
            return flash_attention(
                q, k, v, block_q=min(cfg.flash_block_q, q.shape[2]),
                block_k=min(cfg.flash_block_k, k.shape[2]), layout="bhsd",
            )
        return causal_attention_bhsd(q, k, v)

    def qkv(x, lp, cos, sin):
        h = rms_norm(x, lp["attn_norm"])
        q = torch.einsum("bse,ehd->bhsd", h, lp["wq"])
        k = torch.einsum("bse,ekd->bksd", h, lp["wk"])
        v = torch.einsum("bse,ekd->bksd", h, lp["wv"])
        return apply_rope_bhsd(q, cos, sin), apply_rope_bhsd(k, cos, sin), v

    def gate_up(x, attn, lp):
        """x + attn @ wo, and the MLP's named residuals of its norm."""
        x = x + torch.einsum("bhsd,hde->bse", attn, lp["wo"])
        h = rms_norm(x, lp["mlp_norm"])
        u = torch.einsum("bse,ef->bsf", h, lp["w_up"])
        if gelu:
            return x, u
        return x, torch.einsum("bse,ef->bsf", h, lp["w_gate"]), u

    def down(lp, *res):
        if gelu:
            act = torch.nn.functional.gelu(res[0], approximate="tanh")
        else:
            act = torch.nn.functional.silu(res[0]) * res[1]
        return torch.einsum("bsf,fe->bse", act, lp["w_down"])

    def mlp_block(x, attn, lp):
        x, *res = gate_up(x, attn, lp)
        return x + down(lp, *res)

    def layer(x, lp, cos, sin):
        return mlp_block(x, attend(*qkv(x, lp, cos, sin)), lp)

    def layer_remat(x, lp, cos, sin):
        if policy is None:
            return layer(x, lp, cos, sin)
        if policy == "full":
            return _checkpoint(layer, x, lp, cos, sin)
        q, k, v = _checkpoint(qkv, x, lp, cos, sin)
        if cfg.attention == "flash":
            attn = attend(q, k, v)
        else:
            attn = _checkpoint(attend, q, k, v)
        if policy == "flash_qkv":
            return _checkpoint(mlp_block, x, attn, lp)
        x, *res = _checkpoint(gate_up, x, attn, lp)
        return x + _checkpoint(down, lp, *res)

    def backbone(params, tokens):
        dev = tokens.device
        if dev not in rope_tables:
            rope_tables[dev] = rope_frequencies(cfg.d_head, cfg.max_seq_len,
                                                cfg.rope_theta, device=dev)
        cos, sin = rope_tables[dev]
        x = params["embed"].to(cfg.dtype)[tokens.long()]
        params = _cast_matmul_params(cfg, params)
        layers = params["layers"]
        for i in range(cfg.n_layers):
            x = layer_remat(x, {key: val[i] for key, val in layers.items()},
                            cos, sin)
        x = rms_norm(x, params["final_norm"])
        return x, _unembed_matrix(cfg, params)

    def forward(params, tokens):
        x, unembed = backbone(params, tokens)
        return torch.einsum("bse,ev->bsv", x, unembed)

    if _return_backbone:
        return forward, backbone
    return forward


def make_loss_fn(cfg: TransformerConfig):
    """loss_fn(params, {"tokens": [B, S+1], "mask": optional [B, S+1]})
    -> mean next-token cross-entropy (JAX's `make_loss_fn` :1497), over
    the full logits or, with cfg.loss_chunk, in sequence chunks."""
    forward, backbone = make_forward(cfg, _return_backbone=True)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:].bool()
        if cfg.loss_chunk:
            x, unembed = backbone(params, tokens[:, :-1])
            loss, _ = blockwise_softmax_cross_entropy(
                x, unembed, labels, where=mask, chunk=cfg.loss_chunk)
            return loss
        logits = forward(params, tokens[:, :-1])
        loss, _ = softmax_cross_entropy_with_int_labels(logits, labels, where=mask)
        return loss

    return loss_fn


# --------------------------------------------------------------------------
# paged KV pool + decoder
# --------------------------------------------------------------------------


def paged_kv_block_bytes(cfg: TransformerConfig, block_tokens: int, dtype=None) -> int:
    """Device bytes ONE physical block costs across all layers (K + V)."""
    dtype = dtype or cfg.dtype
    per = cfg.n_layers * block_tokens * cfg.n_kv_heads * cfg.d_head * dtype.itemsize
    return 2 * per


def init_paged_kv_cache(cfg: TransformerConfig, num_blocks: int, block_tokens: int,
                        *, device=None, dtype=None) -> Dict[str, torch.Tensor]:
    """The pooled per-layer KV cache, {"k", "v"} of
    [n_layers, num_blocks, block_tokens, n_kv_heads, d_head]. Block 0 is
    the null block: padded table entries and masked-token writes route
    there (see kv_paging.py)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_tokens, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def make_paged_decoder(cfg: TransformerConfig, temperature: float = 0.0,
                       block_tokens: int = 64):
    """Build the paged fast path: (paged_prefill, paged_decode_step,
    copy_blocks) over a pool from `init_paged_kv_cache`.

    The pool is updated IN PLACE (`index_put_` into its per-layer views)
    where the JAX decoder donated it and returned a new one; each
    function still returns the pool, so call sites read as in JAX.

    paged_prefill(params, pool, table[Nmax], tokens[1,Sb], length, ctx_len,
                  generator, ctx_blocks) -> (next_token[1], logits[1,V], pool)
      B=1 prefill of a prompt SUFFIX whose first `ctx_len` tokens are
      already in the pool (a prefix-cache hit, a prior prefill chunk, or
      0). `length` real tokens of the bucket-padded `tokens` write their
      K/V into the slot's table blocks (padded ones into the null block),
      and attention walks the first `ctx_blocks` + ceil(Sb / bt) table
      blocks in place.

    paged_decode_step(params, pool, tables[B,Nmax], tokens[B],
                      positions[B], write_phys[B], write_off[B], generator)
        -> (next_tokens[B], logits[B,V], pool)
      One cached decode step for every slot: the new K/V is written at
      the host-resolved (physical block, offset) pair — inactive slots
      route to the null block — and attention walks each slot's table.

    copy_blocks(pool, src[n], dst[n]) -> pool
      Copy-on-write: duplicate physical blocks across all layers.

    Every attention call is one `ops.paged_attention` (one kernel launch
    per layer on the card)."""
    bt = int(block_tokens)
    if bt <= 0:
        raise ValueError(f"block_tokens must be positive, got {bt}")
    scale = cfg.d_head ** -0.5
    KV, D = cfg.n_kv_heads, cfg.d_head
    _sample = _make_sampler(temperature, cfg.vocab_pad)
    rope_tables: Dict[torch.device, Any] = {}

    def _layers(params, x, pool, rope_pos, w_phys, w_off, tables, positions,
                kv_len):
        """Every layer over x [B, S, E]: write this step's K/V at
        (w_phys, w_off) first, then attend the pool in place — cache
        content is authoritative for the step's own keys too."""
        cos_sin = rope_tables.get(x.device)
        if cos_sin is None:
            cos_sin = rope_frequencies(cfg.d_head, cfg.max_seq_len,
                                       cfg.rope_theta, device=x.device)
            rope_tables[x.device] = cos_sin
        cos, sin = cos_sin
        w_phys, w_off = w_phys.long(), w_off.long()
        layers = params["layers"]
        for i in range(cfg.n_layers):
            lp = {key: val[i] for key, val in layers.items()}
            kc, vc = pool["k"][i], pool["v"][i]
            h = rms_norm(x, lp["attn_norm"])
            q = torch.einsum("bse,ehd->bshd", h, lp["wq"])
            k = torch.einsum("bse,ekd->bskd", h, lp["wk"])
            v = torch.einsum("bse,ekd->bskd", h, lp["wv"])
            q = apply_rope(q, cos, sin, positions=rope_pos)
            k = apply_rope(k, cos, sin, positions=rope_pos)
            kc.index_put_((w_phys, w_off), k.reshape(-1, KV, D).to(kc.dtype))
            vc.index_put_((w_phys, w_off), v.reshape(-1, KV, D).to(vc.dtype))
            attn = paged_attention(q, kc, vc, tables, positions, scale=scale,
                                   kv_len=kv_len)
            x = x + torch.einsum("bshd,hde->bse", attn, lp["wo"])
            x = x + _mlp(rms_norm(x, lp["mlp_norm"]), lp, cfg)
        return rms_norm(x, params["final_norm"])

    def paged_prefill(params, pool, table, tokens, length, ctx_len, generator,
                      ctx_blocks: int):
        params = _cast_matmul_params(cfg, params)
        dev = tokens.device
        Sb = tokens.shape[1]
        nmax = table.shape[0]
        length, ctx_len = int(length), int(ctx_len)
        G = min(int(ctx_blocks) + -(-Sb // bt), nmax)
        x = params["embed"][tokens.long()].to(cfg.dtype)
        qpos = ctx_len + torch.arange(Sb, device=dev)  # global positions
        valid = torch.arange(Sb, device=dev) < length
        # padded suffix tokens write into the null block (0), never into a
        # real one; their block index can run past the table once a bucket
        # pads past max_seq_len, so it is clamped (JAX's gather clamps)
        blk = table[(qpos // bt).clamp(max=nmax - 1)]
        w_phys = torch.where(valid, blk, torch.zeros_like(blk))
        w_off = qpos % bt
        window = table[:G][None]
        pos = torch.tensor([ctx_len], dtype=torch.int32, device=dev)
        x = _layers(params, x, pool, qpos[None], w_phys, w_off, window, pos,
                    pos + length)
        x_last = x[0, max(length - 1, 0)][None]
        logits = x_last @ _unembed_matrix(cfg, params)
        return _sample(logits, generator), logits, pool

    def paged_decode_step(params, pool, tables, tokens, positions, write_phys,
                          write_off, generator):
        params = _cast_matmul_params(cfg, params)
        x = params["embed"][tokens.long()].to(cfg.dtype)[:, None, :]  # [B,1,E]
        # this token's K/V is written before the attention call, so the
        # live window is positions + 1 keys deep
        x = _layers(params, x, pool, positions[:, None], write_phys, write_off,
                    tables, positions, positions + 1)
        logits = x[:, 0] @ _unembed_matrix(cfg, params)
        return _sample(logits, generator), logits, pool

    def copy_blocks(pool, src, dst):
        src, dst = src.long(), dst.long()
        for a in pool.values():
            a[:, dst] = a[:, src]
        return pool

    return paged_prefill, paged_decode_step, copy_blocks
