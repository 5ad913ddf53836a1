"""The port's PagedDecodeEngine and ContinuousBatcher against the JAX
engine (attention_impl="fused:xla") on the same CONFIGS["tiny"] f32
parameters: greedy decoding must agree token for token, and the paging
machinery (prefix reuse, copy-on-write, preemption, chunked prefill)
must behave as the reference's does. Also holds the ported
BlockAllocator/PrefixCache unit cases of tests/test_kv_paging.py.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models.kv_paging import PagedDecodeEngine as JaxEngine
from ray_tpu_torch.models.kv_paging import (
    BlockAllocator,
    InsufficientBlocksError,
    PagedDecodeEngine,
    PrefixCache,
)
from ray_tpu_torch.models.transformer import CONFIGS
from ray_tpu_torch.serve.batching import ContinuousBatcher, ReplicaDrainingError
from ray_tpu_torch.weights import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: more intra-op threads only contend with the other
    # test workers for the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(J_CONFIGS["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(tiny, **kw):
    """The JAX engine and the port's on the same parameters and options;
    the JAX one always prefills whole prompts."""
    jcfg, tcfg, jparams, tparams = tiny
    jax_kw = {k: v for k, v in kw.items() if k != "prefill_chunk_tokens"}
    j = JaxEngine(jcfg, jparams, attention_impl="fused:xla", **jax_kw)
    t = PagedDecodeEngine(tcfg, tparams, device="cpu", **kw)
    return j, t


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n) for n in lengths]


def _gen(eng, slot, prompt, n):
    """Greedy-generate n tokens through the engine contract (chunked
    admissions included); releases the slot at the end."""
    tok, done = eng.admit(slot, {"tokens": prompt, "max_new_tokens": n})
    out = [] if tok is None else [tok]
    while not done:
        tok, done = eng.step([slot])[slot]
        out.extend(tok if isinstance(tok, list) else [tok])
    eng.release(slot)
    return out


def _run_script(eng, script):
    """Drive an engine through (step index, slot, prompt, max_new) admits,
    stepping every live slot once per index; returns each admission's
    tokens. Finished slots are released and may be reused by later
    admits."""
    outs, active = {}, {}
    steps = max(s[0] for s in script) + 64
    for i in range(steps):
        for at, slot, prompt, n in script:
            if at == i:
                rid = len(outs)
                tok, done = eng.admit(slot, {"tokens": prompt, "max_new_tokens": n})
                outs[rid] = [] if tok is None else [tok]
                if done:
                    eng.release(slot)
                else:
                    active[slot] = rid
        if active:
            for slot, (tok, done) in eng.step(sorted(active)).items():
                rid = active[slot]
                outs[rid].extend(tok if isinstance(tok, list) else [tok])
                if done:
                    del active[slot]
                    eng.release(slot)
        if not active and i > max(s[0] for s in script):
            break
    return outs


# ------------------------------------------------------------- allocator


def test_allocator_refcount_and_null_block():
    a = BlockAllocator(8)
    assert a.num_usable == 7 and a.num_free == 7
    blocks = a.alloc(3)
    assert 0 not in blocks and a.num_free == 4
    a.incref(blocks[0])
    a.decref(blocks[0])
    assert a.num_free == 4  # still held
    for b in blocks:
        a.decref(b)
    assert a.num_free == 7
    with pytest.raises(InsufficientBlocksError):
        a.alloc(8)
    with pytest.raises(ValueError):
        a.decref(blocks[0])  # double free


def test_prefix_cache_eviction_is_leaf_first():
    a = BlockAllocator(8)
    cache = PrefixCache(a, block_tokens=4)
    prompt = np.arange(12, dtype=np.int32)
    blocks = a.alloc(3)
    cache.register(prompt, blocks)
    for b in blocks:
        a.decref(b)  # only the cache holds them now
    assert cache.evictable() == 3
    # a one-block eviction takes the LEAF, so the remaining chain still
    # matches a 2-block prefix
    assert cache.evict(1) == 1
    assert cache.match_count(prompt, 3) == 2


# ------------------------------------------------- engine vs JAX engine


def test_staggered_admissions_and_slot_reuse_match_reference(tiny):
    """Admissions land mid-generation of others, block boundaries fall
    mid-decode, and freed slots are reused by later requests."""
    p = _prompts((5, 9, 17, 30, 11, 3), seed=1)
    script = [
        (0, 0, p[0], 12), (0, 1, p[1], 4), (2, 2, p[2], 20),
        (3, 3, p[3], 6), (7, 1, p[4], 9), (12, 3, p[5], 14),
    ]
    j, t = _engines(tiny, max_batch_size=4, block_tokens=8)
    assert _run_script(t, script) == _run_script(j, script)
    assert t.prefills == j.prefills == 6


def test_eos_and_max_new_tokens_caps_match_reference(tiny):
    p = _prompts((7, 12), seed=2)
    free_run = _gen(_engines(tiny, max_batch_size=1, block_tokens=8)[1], 0, p[0], 10)
    eos = free_run[3]  # stops the first prompt at its 4th token
    j, t = _engines(tiny, max_batch_size=2, block_tokens=8, eos_id=eos)
    script = [(0, 0, p[0], 10), (0, 1, p[1], 5)]
    got = _run_script(t, script)
    assert got == _run_script(j, script)
    assert got[0][-1] == eos and len(got[0]) == free_run.index(eos) + 1
    assert len(got[1]) <= 5


def test_prompt_of_exactly_max_seq_len_matches_reference(tiny):
    """A max_seq_len prompt emits exactly one token and finishes; its
    padded prefill and the finished slot's rope rows clamp."""
    prompt = _prompts((128,), seed=3)[0]
    j, t = _engines(tiny, max_batch_size=2, block_tokens=8, prefix_cache=False)
    for eng in (j, t):
        eng.admit(1, {"tokens": prompt[:20], "max_new_tokens": 3})
        eng.step([1])
    tt = t.admit(0, {"tokens": prompt, "max_new_tokens": 5})
    jt = j.admit(0, {"tokens": prompt, "max_new_tokens": 5})
    assert tt == jt and tt[1] is True
    # slot 0 is finished at position max_seq_len but not released: the
    # next decode step carries it as a row whose rope index clamps
    assert t.step([1]) == j.step([1])


def test_prefix_hit_skips_prefill_and_matches_reference(tiny):
    prompt = _prompts((21,), seed=4)[0]  # bt=8: 2 full blocks <= len-1
    j, t = _engines(tiny, max_batch_size=2, block_tokens=8)
    cold = _gen(t, 0, prompt, 6)
    assert cold == _gen(j, 0, prompt, 6)
    assert t.prefix_hits == 0 and t.prefill_tokens == 21
    hit = _gen(t, 1, prompt, 6)
    assert hit == cold
    assert t.prefix_hits == 1 and t.prefix_tokens_reused == 16
    assert t.prefill_tokens == 21 + 5  # only the tail past the shared span
    other = prompt.copy()
    other[18:] = (other[18:] + 1) % 256
    assert _gen(t, 0, other, 6) == _gen(j, 1, other, 6)
    assert t.prefix_hits == 2 and j.prefix_hits == 1
    assert t.prefill_tokens == 21 + 5 + 5


def test_fork_copy_on_write_matches_reference(tiny):
    prompt = _prompts((13,), seed=5)[0]
    outs = []
    for eng in _engines(tiny, max_batch_size=2, block_tokens=8, prefix_cache=False):
        eng.admit(0, {"tokens": prompt, "max_new_tokens": 30})
        for _ in range(2):
            eng.step([0])  # position 15: the tail block is partial
        eng.fork(0, 1)
        eng.force_token(0, 5)
        eng.force_token(1, 9)
        got = {0: [], 1: []}
        for _ in range(5):
            r = eng.step([0, 1])
            for s in (0, 1):
                got[s].append(r[s][0])
        assert eng.cow_copies >= 1  # the shared tail block was un-shared
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][0] != outs[0][1]


def test_preemption_storm_through_batcher_matches_reference(tiny):
    """Twice the pool's worth of generations through the port's
    ContinuousBatcher: the engine preempts and parks, the batcher
    readmits, and every stream delivers exactly the reference tokens."""
    prompts = _prompts((9, 10, 11, 12, 13, 14), seed=6)
    j, _ = _engines(tiny, max_batch_size=1, block_tokens=8, prefix_cache=False)
    refs = [_gen(j, 0, p, 25) for p in prompts]
    _, t = _engines(tiny, max_batch_size=4, block_tokens=8, num_blocks=13,
                    prefix_cache=False)
    b = ContinuousBatcher(t, max_batch_size=4, batch_wait_timeout_s=0.01)
    try:
        streams = [b.submit(tokens=p, max_new_tokens=25) for p in prompts]
        outs = [list(s) for s in streams]
        assert t.preemptions >= 1, t.stats()
        assert outs == refs
        assert not any(s.cut for s in streams)
        stats = b.stats()
        assert stats["kv_blocks_total"] == 12
        assert stats["preemptions"] == t.preemptions
    finally:
        b.close()


def test_batcher_parks_insufficient_blocks_then_drains(tiny):
    """InsufficientBlocksError from the port's engine parks the request
    (it waits, then completes) instead of failing it; after drain() new
    submissions are refused. The budget check is bypassed so admission
    reaches the engine and raises."""
    _, t = _engines(tiny, max_batch_size=2, block_tokens=8, num_blocks=7,
                    prefix_cache=False)  # 6 usable blocks
    t.can_admit = lambda request: True
    b = ContinuousBatcher(t, max_batch_size=2, batch_wait_timeout_s=0.0)
    try:
        first = b.submit(tokens=_prompts((9,), seed=7)[0], max_new_tokens=20)
        # needs 5 prompt blocks; only fits once `first` retires
        second = b.submit(tokens=_prompts((33,), seed=8)[0], max_new_tokens=2)
        got = {}
        th = threading.Thread(target=lambda: got.update(b=list(second)))
        th.start()
        assert len(list(first)) == 20
        th.join(timeout=120)
        assert not th.is_alive() and len(got["b"]) == 2
        b.drain()
        with pytest.raises(ReplicaDrainingError):
            b.submit(tokens=[1, 2, 3])
    finally:
        b.close()


@pytest.mark.parametrize("chunk", [7, 8])
def test_chunked_prefill_matches_reference(tiny, chunk):
    """Long prompts stream in chunks (boundaries mid-block at 7, aligned
    at 8) interleaved with a short stream's decode; tokens equal the JAX
    engine's whole-prompt run, and the counters show the chunking."""
    p = _prompts((40, 6, 23), seed=9)
    script = [(0, 0, p[0], 8), (0, 1, p[1], 12), (3, 2, p[2], 6)]
    j, t = _engines(tiny, max_batch_size=3, block_tokens=8,
                    prefill_chunk_tokens=chunk)
    assert _run_script(t, script) == _run_script(j, script)
    assert t.chunked_prefills == 2
    assert t.prefill_chunks == -(-40 // chunk) + 1 + -(-23 // chunk)
    assert t.stats()["prefilling"] == 0


def test_temperature_stream_is_invariant_to_chunking(tiny):
    """Intermediate prefill chunks sample from a throwaway generator, so
    the engine's own generator is drawn once per admission and a sampled
    stream does not depend on the chunk size; the same seed repeats it."""
    _, tcfg, _, tparams = tiny
    prompt = _prompts((29,), seed=10)[0]
    outs = []
    for chunk in (0, 7, 0):
        eng = PagedDecodeEngine(tcfg, tparams, device="cpu", max_batch_size=1,
                                block_tokens=8, temperature=1.0, seed=3,
                                prefill_chunk_tokens=chunk)
        outs.append(_gen(eng, 0, prompt, 12))
    assert outs[0] == outs[1] == outs[2]
    assert len(set(outs[0])) > 3  # sampled, not a constant stream
