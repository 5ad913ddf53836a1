"""Paged KV-cache subsystem: block allocator, prefix reuse, preemption
(port of ray_tpu/models/kv_paging.py).

The KV cache is a POOL of fixed-size token blocks (the vLLM PagedAttention
memory model) plus the host-side machinery that makes the pool safe to
oversubscribe:

  BlockAllocator    refcounted free-list over the physical blocks; block 0
                    is the reserved null block (padding writes and padded
                    table entries route there, never into live data).
  PrefixCache       hash-trie over FULL prompt blocks with chained keys:
                    identical prompt prefixes map to the same physical
                    blocks, so a prefix hit admits by increfing blocks
                    instead of recomputing prefill for the shared span.
                    Cache-held blocks are evicted LRU-leaf-first under
                    pool pressure.
  PagedDecodeEngine the `ContinuousBatcher` engine contract (admit / step /
                    release) over the pool, plus can_admit (worst-case
                    block budget), fork (copy-on-write sharing) and
                    take_preempted (generations evicted under pool
                    exhaustion, parked as recompute-on-readmit requests).

Preemption contract: when a decode step needs blocks the pool cannot
supply (even after cache eviction), the NEWEST generations are preempted —
their blocks freed, their full token history parked — until the rest fit.
A parked generation readmits as a plain prefill of prompt + generated
tokens; with greedy sampling the resumed stream is token-for-token what
the uninterrupted run would have produced.

The engine runs the fp pool only. Not ported yet: the int8 pool,
speculative decoding, per-token logprobs, cross-replica KV transfer, live
weight swap, telemetry and device meshes.

Not thread-safe: one loop thread (the batcher's) owns admit/step/release;
stats() reads are safe from other threads (plain int reads).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _config, resolve_device
from .decoding import default_prefill_buckets
from .transformer import (
    TransformerConfig,
    init_paged_kv_cache,
    init_params,
    make_paged_decoder,
    paged_kv_block_bytes,
)


class InsufficientBlocksError(RuntimeError):
    """The pool cannot cover an admission's block need even after cache
    eviction. Raised by admit(); ContinuousBatcher parks the request for
    retry instead of failing it (blocks free as generations retire)."""


class BlockAllocator:
    """Refcounted fixed pool of KV blocks. Block 0 is the permanently-held
    null block: padded block-table entries and masked token writes target
    it, so it is never handed out."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is the null block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._ref = np.zeros(self.num_blocks, np.int32)
        self._ref[0] = 1  # null block: never allocated, never freed
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise InsufficientBlocksError(
                f"need {n} KV blocks, {len(self._free)} free"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"incref of free block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"decref of free block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])


class PrefixCache:
    """Hash-trie over full prompt blocks.

    A node's key is sha1(parent_key || block tokens), so a chain of keys
    identifies a prompt prefix by content AND position — two prompts share
    a node iff they share every token up to and including that block. The
    cache holds its own reference on every registered block; a block whose
    only reference is the cache's (refcount 1) is evictable, leaf-first in
    LRU order so chains never dangle."""

    def __init__(self, allocator: BlockAllocator, block_tokens: int):
        self._alloc = allocator
        self.block_tokens = int(block_tokens)
        # key -> {"block": int, "parent": key, "ts": int}
        self._nodes: Dict[bytes, Dict[str, Any]] = {}
        self._children: Dict[bytes, set] = {}
        self._clock = 0
        self.hits = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _child_key(self, parent: bytes, block_tokens: np.ndarray) -> bytes:
        h = hashlib.sha1()
        h.update(parent or b"root")
        h.update(np.ascontiguousarray(block_tokens, np.int32).tobytes())
        return h.digest()

    def _chain(self, prompt: np.ndarray, max_blocks: int):
        bt = self.block_tokens
        key = b""
        for bi in range(max_blocks):
            key = self._child_key(key, prompt[bi * bt:(bi + 1) * bt])
            node = self._nodes.get(key)
            if node is None:
                return
            yield key, node

    def lookup(self, prompt: np.ndarray, max_blocks: int) -> List[int]:
        """Longest cached chain of full blocks matching the prompt prefix;
        returns the physical block ids (LRU-touched, NOT increfed — the
        caller takes its references)."""
        out = []
        for _, node in self._chain(prompt, max_blocks):
            node["ts"] = self._tick()
            out.append(node["block"])
        if out:
            self.hits += 1
        return out

    def match_count(self, prompt: np.ndarray, max_blocks: int) -> int:
        """lookup() length without the LRU touch (admission budgeting)."""
        return sum(1 for _ in self._chain(prompt, max_blocks))

    def match_blocks(self, prompt: np.ndarray, max_blocks: int) -> List[int]:
        """lookup() without the LRU touch (admission budgeting)."""
        return [node["block"] for _, node in self._chain(prompt, max_blocks)]

    def register(self, prompt: np.ndarray, blocks: Sequence[int]) -> None:
        """Insert the prompt's first len(blocks) full blocks. New nodes
        incref their block (the cache's own reference); existing nodes are
        only LRU-touched (their block is already the canonical one)."""
        key = b""
        for bi, block in enumerate(blocks):
            parent = key
            key = self._child_key(
                key, prompt[bi * self.block_tokens:(bi + 1) * self.block_tokens]
            )
            node = self._nodes.get(key)
            if node is None:
                self._nodes[key] = {"block": int(block), "parent": parent,
                                    "ts": self._tick()}
                self._children.setdefault(parent, set()).add(key)
                self._alloc.incref(int(block))
            else:
                node["ts"] = self._tick()

    def evictable(self) -> int:
        """Blocks the cache could eventually free: held only by the cache
        (refcount 1). Counts non-leaves too — leaf-first eviction reaches
        them once their children go. Safe to call off the loop thread
        (stats polling): iterates an atomic snapshot of the node table."""
        return sum(
            1 for n in list(self._nodes.values())
            if self._alloc.refcount(n["block"]) == 1
        )

    def evict(self, n: int) -> int:
        """Free up to n blocks, LRU childless-first; returns blocks freed.
        One scan collects every current victim (childless, cache-only) and
        evicts LRU-first from that batch; the outer loop re-scans only when
        a whole batch was consumed and more is needed (evicting leaves can
        expose their parents)."""
        freed = 0
        while freed < n:
            candidates = sorted(
                (node["ts"], key) for key, node in self._nodes.items()
                if not self._children.get(key)
                and self._alloc.refcount(node["block"]) == 1
            )
            if not candidates:
                break
            for _, key in candidates:
                if freed >= n:
                    break
                node = self._nodes.pop(key)
                self._children.get(node["parent"], set()).discard(key)
                self._children.pop(key, None)
                self._alloc.decref(node["block"])
                self.evictions += 1
                freed += 1
        return freed


class PagedDecodeEngine:
    """Block-granular KV-cache decode engine (module docstring has the
    architecture): the ContinuousBatcher engine contract admit / step /
    release, plus the paging hooks the batcher discovers by duck-typing
    (can_admit, take_preempted). Runs on CUDA unless `device` names
    another device."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params=None,
        *,
        device=None,
        max_batch_size: int = 8,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        default_max_new_tokens: int = 64,
        max_seq_len: Optional[int] = None,
        seed: int = 0,
        block_tokens: Optional[int] = None,
        num_blocks: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        prefill_chunk_tokens: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch_size = int(max_batch_size)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError("max_seq_len exceeds the model's rope tables")
        self.block_tokens = int(block_tokens or _config.SERVE_KV_BLOCK_TOKENS)
        bt = self.block_tokens
        self.blocks_per_slot = -(-self.max_seq_len // bt)
        self.kv_block_bytes = paged_kv_block_bytes(cfg, bt)

        prefill_chunk_tokens = int(
            _config.SERVE_PREFILL_CHUNK_TOKENS if prefill_chunk_tokens is None
            else prefill_chunk_tokens
        )
        if prefill_chunk_tokens < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 0 (0 = whole-prompt "
                f"prefill), got {prefill_chunk_tokens}"
            )
        self.prefill_chunk_tokens = prefill_chunk_tokens

        if num_blocks is None:
            num_blocks = _config.SERVE_KV_CACHE_BLOCKS
        if not num_blocks:
            # dense-equivalent budget (+1 for the null block): paging then
            # wins by oversubscription
            num_blocks = 1 + self.max_batch_size * self.blocks_per_slot
        self.num_blocks = int(num_blocks)

        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen, device=self.device, dtype=cfg.dtype)
        self.params = params
        self.allocator = BlockAllocator(self.num_blocks)
        if prefix_cache is None:
            prefix_cache = bool(_config.SERVE_KV_PREFIX_CACHE)
        self.prefix_cache = (
            PrefixCache(self.allocator, bt) if prefix_cache else None
        )
        self.pool = init_paged_kv_cache(cfg, self.num_blocks, bt,
                                        device=self.device)
        self._prefill, self._decode_step, self._copy_blocks = make_paged_decoder(
            cfg, temperature=temperature, block_tokens=bt
        )
        # prompts pad to these lengths; the last is max_seq_len, which also
        # covers a readmission's prompt + generated-so-far
        self.buckets = default_prefill_buckets(self.max_seq_len)
        # one generator for every sampled token; intermediate prefill
        # chunks sample from a throwaway one, so temperature > 0 streams
        # do not depend on the chunk size
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed + 1)
        self._throwaway_rng = torch.Generator(device=self.device)

        B = self.max_batch_size
        self._tables = np.zeros((B, self.blocks_per_slot), np.int32)
        self._row_blocks = np.zeros(B, np.int32)  # allocated entries per row
        self._live = np.zeros(B, bool)
        self._positions = np.zeros(B, np.int32)
        self._last_tokens = np.zeros(B, np.int32)
        self._new_counts = np.zeros(B, np.int64)
        self._max_new = np.full(B, self.default_max_new_tokens, np.int64)
        self._history: List[Optional[List[int]]] = [None] * B
        # chunked prefill: the slot's FULL prompt while its prefill is
        # still streaming in chunks (committed span = _positions[slot]);
        # None once the slot is generating
        self._chunk_state: List[Optional[np.ndarray]] = [None] * B
        self._admit_seq = np.zeros(B, np.int64)
        self._seq = 0
        self._preempted: List[Tuple[int, Dict[str, Any]]] = []

        # counters (observability/tests)
        self.tokens_generated = 0
        self.prefills = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0     # paged-prefill dispatches (>= prefills)
        self.chunked_prefills = 0   # admissions that streamed in chunks
        self.decode_steps = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.preemptions = 0
        self.cow_copies = 0

    # ------------------------------------------------------------- internals

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _bucket(self, length: int) -> int:
        for b in self.buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt of {length} tokens exceeds max_seq_len {self.max_seq_len}"
        )

    def _ctx_bucket_blocks(self, ctx_len: int) -> int:
        """Pad the context block count to the same bucket boundaries as
        prompt lengths (the prefill attention window's size)."""
        if ctx_len <= 0:
            return 0
        bucketed = min(self._bucket(ctx_len), self.max_seq_len)
        return min(-(-bucketed // self.block_tokens), self.blocks_per_slot)

    def _done(self, slot: int, token: int) -> bool:
        if self.eos_id is not None and token == self.eos_id:
            return True
        if self._new_counts[slot] >= self._max_new[slot]:
            return True
        return int(self._positions[slot]) >= self.max_seq_len

    def _release_blocks(self, slot: int) -> None:
        for bi in range(int(self._row_blocks[slot])):
            b = int(self._tables[slot, bi])
            if b:
                self.allocator.decref(b)
        self._tables[slot, :] = 0
        self._row_blocks[slot] = 0
        self._live[slot] = False
        self._history[slot] = None
        self._chunk_state[slot] = None

    def _reclaim(self, need: int) -> None:
        """Evict cache-only blocks until `need` blocks are free (best
        effort — callers decide between raising and preempting)."""
        short = need - self.allocator.num_free
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)

    def _preempt(self, slot: int) -> None:
        remaining = int(self._max_new[slot] - self._new_counts[slot])
        parked = {
            # full history (prompt + generated, incl. the pending last
            # token): readmission prefills it and the NEXT sampled token
            # continues the stream exactly where it stopped (greedy)
            "tokens": list(self._history[slot] or []),
            "max_new_tokens": max(1, remaining),
        }
        self._preempted.append((slot, parked))
        self.preemptions += 1
        self._release_blocks(slot)

    # ----------------------------------------------------------- engine API

    def worst_case_blocks(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request can EVER need: its full prompt + max_new span,
        capped at max_seq_len — the one formula behind admission."""
        span = min(int(prompt_len) + int(max_new), self.max_seq_len)
        return -(-span // self.block_tokens)

    def can_admit(self, request: Dict[str, Any]) -> bool:
        """Worst-case block-budget admission check: free + cache-evictable
        blocks must cover the request's full prompt + max_new_tokens span,
        minus the blocks a prefix hit would reuse. The batcher calls this
        BEFORE taking a slot, so over-capacity requests queue instead of
        thrashing the pool."""
        prompt = np.asarray(request["tokens"], np.int32)
        length = int(prompt.size)
        if length == 0 or length > self.max_seq_len:
            return True  # let admit() raise the real validation error
        mnt = request.get("max_new_tokens")
        mnt = self.default_max_new_tokens if mnt is None else max(1, int(mnt))
        worst = self.worst_case_blocks(length, mnt)
        if worst > self.allocator.num_usable:
            # can NEVER fit: report admissible so the batcher routes it to
            # admit(), whose worst-case check fails it with the hard
            # ValueError — parking it would wedge the admission line
            return True
        reusable = 0
        evictable = 0
        if self.prefix_cache is not None:
            evictable = self.prefix_cache.evictable()
            if length > 1:
                hits = self.prefix_cache.match_blocks(
                    prompt, (length - 1) // self.block_tokens
                )
                reusable = len(hits)
                # a cache-only hit block is counted in evictable() but
                # admission will PIN it, not evict it
                evictable -= sum(
                    1 for b in hits if self.allocator.refcount(b) == 1
                )
        budget = self.allocator.num_free + max(0, evictable)
        return budget >= worst - reusable

    def admit(
        self, slot: int, request: Dict[str, Any]
    ) -> Tuple[Optional[int], bool]:
        """Prefill `request` into `slot`, reusing cached prefix blocks.

        With `prefill_chunk_tokens > 0` a prompt longer than one chunk
        admits CHUNKED: only the first chunk prefills here and the call
        returns (None, False) — step() advances one chunk per engine step
        (interleaved with other slots' decode) until the prompt is
        consumed and the first token samples. Shorter prompts (and
        chunking off) prefill whole and return (first_token, done).

        Raises InsufficientBlocksError (retryable: the batcher parks the
        request) when the pool cannot cover the prompt itself."""
        bt = self.block_tokens
        prompt = np.asarray(request["tokens"], np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("request['tokens'] must be a non-empty 1-D seq")
        length = int(prompt.size)
        # length == max_seq_len is admittable: it emits exactly ONE token
        # and finishes without a cache write — which is also what makes a
        # generation preempted at its very last position readmittable
        if length > self.max_seq_len:
            raise ValueError(
                f"prompt of {length} tokens exceeds max_seq_len "
                f"{self.max_seq_len}"
            )
        mnt = request.get("max_new_tokens")
        mnt = self.default_max_new_tokens if mnt is None else max(1, int(mnt))
        # a request whose WORST-CASE span can never fit the pool is
        # rejected before any token flows; length + max_new is invariant
        # across preemption cycles, so readmission can never hard-fail
        worst = self.worst_case_blocks(length, mnt)
        if worst > self.allocator.num_usable:
            raise ValueError(
                f"request worst case of {worst} KV blocks "
                f"({length} prompt + up to {mnt} new tokens) exceeds the "
                f"pool's {self.allocator.num_usable} blocks"
            )
        if self._live[slot]:
            self._release_blocks(slot)

        # prefix reuse: longest chain of cached FULL blocks, capped at
        # length-1 so at least one real token remains to prefill (its
        # hidden state produces the first sampled token)
        hit_blocks: List[int] = []
        if self.prefix_cache is not None and length > 1:
            hit_blocks = self.prefix_cache.lookup(prompt, (length - 1) // bt)
        p_hit = len(hit_blocks) * bt
        for b in hit_blocks:
            self.allocator.incref(b)

        total_prompt_blocks = -(-length // bt)
        need = total_prompt_blocks - len(hit_blocks)
        self._reclaim(need)
        try:
            new_blocks = self.allocator.alloc(need)
        except InsufficientBlocksError:
            for b in hit_blocks:
                self.allocator.decref(b)
            # retrying only helps if another live generation can retire
            # and free blocks; without one the failure is PERMANENT
            others_live = any(
                self._live[s] for s in range(self.max_batch_size)
                if s != slot
            )
            if total_prompt_blocks > self.allocator.num_usable or not others_live:
                raise ValueError(
                    f"prompt needs {total_prompt_blocks} KV blocks "
                    f"({need} beyond its prefix hits) but only "
                    f"{self.allocator.num_free} of "
                    f"{self.allocator.num_usable} can free up"
                ) from None
            raise
        row = hit_blocks + new_blocks
        self._tables[slot, :] = 0
        self._tables[slot, :len(row)] = row
        self._row_blocks[slot] = len(row)
        self._live[slot] = True

        self._positions[slot] = p_hit  # committed span so far
        self._max_new[slot] = mnt
        self._new_counts[slot] = 0
        self._history[slot] = [int(t) for t in prompt[:length]]
        self._chunk_state[slot] = np.ascontiguousarray(
            prompt[:length], dtype=np.int32
        )
        self._seq += 1
        self._admit_seq[slot] = self._seq
        self.prefills += 1
        if hit_blocks:
            self.prefix_hits += 1
            self.prefix_tokens_reused += p_hit

        chunk = self.prefill_chunk_tokens
        if chunk and length - p_hit > chunk:
            # chunked admission: run the FIRST chunk now; step() advances
            # one chunk per engine step, interleaved with everyone else's
            # decode, until the prompt is consumed
            self.chunked_prefills += 1
            tok = self._run_prefill_chunk(slot)
        else:
            tok = self._run_prefill_chunk(slot, whole=True)
        if tok is None:
            return None, False
        return tok, self._done(slot, tok)

    def _run_prefill_chunk(self, slot: int, whole: bool = False) -> Optional[int]:
        """Consume the next prompt span of the slot's pending prefill (one
        prefill_chunk_tokens chunk, or the whole remainder with
        `whole=True`) through ONE paged-prefill dispatch. Returns the first
        sampled token when this call consumed the prompt's tail, else None.
        Mid-prompt chunk boundaries need not be block-aligned: the
        straddled block is slot-owned (prefix sharing is whole-block)."""
        bt = self.block_tokens
        prompt = self._chunk_state[slot]
        ctx = int(self._positions[slot])
        length = int(prompt.size)
        rem = length - ctx
        take = rem if whole else min(self.prefill_chunk_tokens, rem)
        last = take == rem
        bucket = self._bucket(take)
        padded = np.zeros(bucket, np.int32)
        padded[:take] = prompt[ctx:ctx + take]
        ctx_blocks = self._ctx_bucket_blocks(ctx)
        # intermediate chunks sample a throwaway token from a FIXED
        # generator: only the completing dispatch draws from the engine's
        # stream, one draw per admission regardless of chunking
        if last:
            gen = self._rng
        else:
            gen = self._throwaway_rng
            gen.manual_seed(0)
        next_tok, _, self.pool = self._prefill(
            self.params, self.pool, self._dev(self._tables[slot]),
            self._dev(padded[None]), take, ctx, gen, ctx_blocks,
        )
        self._positions[slot] = ctx + take
        self.prefill_tokens += take
        self.prefill_chunks += 1
        if not last:
            return None
        tok = int(next_tok[0])
        self._chunk_state[slot] = None
        self._last_tokens[slot] = tok
        self._new_counts[slot] = 1
        hist = self._history[slot]
        if hist is not None:
            hist.append(tok)
        self.tokens_generated += 1
        # make this prompt's full blocks (hit + freshly computed) reusable
        if self.prefix_cache is not None:
            reg = (length - 1) // bt
            if reg:
                self.prefix_cache.register(
                    prompt, [int(b) for b in self._tables[slot, :reg]]
                )
        return tok

    def fork(self, src: int, dst: int) -> None:
        """Share ALL of src's blocks (including the partial tail) with dst:
        zero-copy generation fork. The first divergent write into a shared
        block triggers copy-on-write in step()."""
        if not self._live[src]:
            raise ValueError(f"fork source slot {src} is not live")
        if self._chunk_state[src] is not None:
            raise ValueError(
                f"fork source slot {src} is still prefilling (chunked)"
            )
        if self._live[dst]:
            self._release_blocks(dst)
        self._tables[dst] = self._tables[src].copy()
        self._row_blocks[dst] = self._row_blocks[src]
        for bi in range(int(self._row_blocks[src])):
            b = int(self._tables[src, bi])
            if b:
                self.allocator.incref(b)
        self._live[dst] = True
        self._positions[dst] = self._positions[src]
        self._last_tokens[dst] = self._last_tokens[src]
        self._new_counts[dst] = self._new_counts[src]
        self._max_new[dst] = self._max_new[src]
        self._history[dst] = list(self._history[src] or [])
        self._seq += 1
        self._admit_seq[dst] = self._seq

    def force_token(self, slot: int, token: int) -> None:
        """Teacher-force the next input token for `slot` (replaces the
        pending sampled token)."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        if self._chunk_state[slot] is not None:
            raise ValueError(
                f"slot {slot} is still prefilling (chunked) — no pending "
                "sampled token to replace"
            )
        self._last_tokens[slot] = int(token)
        hist = self._history[slot]
        if hist:
            hist[-1] = int(token)

    def step(self, slots: List[int]) -> Dict[int, Tuple[Any, bool]]:
        """One engine step for the live slots in `slots`: (token, done)
        per decoding slot. Slots the pool cannot grow are PREEMPTED (newest
        first) rather than OOMing; they are absent from the result and
        surface via take_preempted().

        Slots still streaming a chunked prefill advance by ONE chunk per
        step and report ([], False) until their prompt is consumed (the
        completing chunk reports ([tok], done)); every other slot decodes
        in the same step."""
        surviving = [s for s in sorted(set(slots)) if self._live[s]]
        if not surviving:
            return {}
        out: Dict[int, Tuple[Any, bool]] = {}
        prefilling = [
            s for s in surviving if self._chunk_state[s] is not None
        ]
        for s in prefilling:
            tok = self._run_prefill_chunk(s)
            if tok is None:
                out[s] = ([], False)
            else:
                out[s] = ([tok], self._done(s, tok))
        decoding = [s for s in surviving if self._chunk_state[s] is None
                    and s not in out]
        if decoding:
            out.update(self._plain_step(decoding))
        return out

    def _span_need(self, surviving: List[int], block_span) -> int:
        """Blocks the write spans require right now: unallocated entries
        plus shared blocks that must copy-on-write (conservative across
        slots: a block shared between two stepping forks counts twice)."""
        need = 0
        for s in surviving:
            for bi in block_span(s):
                blk = int(self._tables[s, bi])
                if blk == 0 or self.allocator.refcount(blk) > 1:
                    need += 1
        return need

    def _reserve_write_spans(self, surviving: List[int], block_span) -> List[int]:
        """Make every block index in block_span(s) writable for each
        surviving slot — allocated and exclusively owned: evict cache
        blocks, preempt newest-first under pressure, then allocate +
        copy-on-write. Returns the surviving list (shrunk by preemptions).

        Newest-first is GLOBAL: slots mid-chunked-prefill are not in
        `surviving` but they ARE preemption candidates — a freshly
        admitted long prompt is the newest work with the least to
        recompute."""
        prefilling = [
            s for s in range(self.max_batch_size)
            if self._live[s] and self._chunk_state[s] is not None
            and s not in surviving
        ]
        while True:
            need = self._span_need(surviving, block_span)
            self._reclaim(need)
            if need <= self.allocator.num_free:
                break
            victim = max(surviving + prefilling,
                         key=lambda s: self._admit_seq[s])
            self._preempt(victim)
            if victim in prefilling:
                prefilling.remove(victim)
                continue
            surviving.remove(victim)
            if not surviving:
                return surviving

        cow_src: List[int] = []
        cow_dst: List[int] = []
        for s in surviving:
            for bi in block_span(s):
                blk = int(self._tables[s, bi])
                if blk and self.allocator.refcount(blk) == 1:
                    continue  # an earlier CoW this step already un-shared it
                nb = self.allocator.alloc(1)[0]
                if blk:  # shared: copy-on-write before this slot's write
                    cow_src.append(blk)
                    cow_dst.append(nb)
                    self.allocator.decref(blk)
                    self.cow_copies += 1
                self._tables[s, bi] = nb
                self._row_blocks[s] = max(int(self._row_blocks[s]), bi + 1)
        if cow_src:
            self.pool = self._copy_blocks(
                self.pool, self._dev(np.asarray(cow_src, np.int32)),
                self._dev(np.asarray(cow_dst, np.int32)),
            )
        return surviving

    def _plain_step(self, surviving: List[int]) -> Dict[int, Tuple[Any, bool]]:
        bt = self.block_tokens
        # resolve this step's block needs (new block at a block boundary,
        # copy-on-write when the write block is shared) under pool pressure
        surviving = self._reserve_write_spans(
            surviving,
            lambda s: (int(self._positions[s]) // bt,),
        )
        if not surviving:
            return {}

        B = self.max_batch_size
        write_phys = np.zeros(B, np.int32)  # inactive rows -> null block
        write_off = np.zeros(B, np.int32)
        for s in surviving:
            pos = int(self._positions[s])
            write_phys[s] = self._tables[s, pos // bt]
            write_off[s] = pos % bt
        next_toks, _, self.pool = self._decode_step(
            self.params, self.pool, self._dev(self._tables),
            self._dev(self._last_tokens), self._dev(self._positions),
            self._dev(write_phys), self._dev(write_off), self._rng,
        )
        toks = next_toks.cpu().numpy()
        out: Dict[int, Tuple[Any, bool]] = {}
        for s in surviving:
            tok = int(toks[s])
            self._positions[s] += 1
            self._last_tokens[s] = tok
            self._new_counts[s] += 1
            hist = self._history[s]
            if hist is not None:
                hist.append(tok)
            out[s] = (tok, self._done(s, tok))
        self.decode_steps += 1
        self.tokens_generated += len(surviving)
        return out

    def take_preempted(self) -> List[Tuple[int, Dict[str, Any]]]:
        """(slot, parked_request) pairs preempted since the last call. The
        parked request readmits through the normal admit path (prefill of
        prompt + generated so far = recompute-on-readmit)."""
        out, self._preempted = self._preempted, []
        return out

    def release(self, slot: int) -> None:
        """Free a slot's blocks (idempotent; cache-registered blocks stay
        resident under the cache's own reference until evicted)."""
        if self._live[slot]:
            self._release_blocks(slot)
        self._new_counts[slot] = 0

    def stats(self) -> Dict[str, Any]:
        used = self.allocator.num_usable - self.allocator.num_free
        return {
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefill_chunks": self.prefill_chunks,
            "chunked_prefills": self.chunked_prefills,
            "prefilling": sum(
                1 for st in self._chunk_state if st is not None
            ),
            "decode_steps": self.decode_steps,
            "max_batch_size": self.max_batch_size,
            "block_tokens": self.block_tokens,
            "kv_block_bytes": self.kv_block_bytes,
            # counts the reserved null block too
            "kv_pool_bytes": self.kv_block_bytes * self.num_blocks,
            "kv_blocks_total": self.allocator.num_usable,
            "kv_blocks_free": self.allocator.num_free,
            "kv_block_utilization": round(
                used / max(1, self.allocator.num_usable), 4
            ),
            "kv_blocks_cached": (
                self.prefix_cache.evictable() if self.prefix_cache else 0
            ),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "preemptions": self.preemptions,
            "cow_copies": self.cow_copies,
        }
