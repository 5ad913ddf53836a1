"""The port's paged decoder (ray_tpu_torch.models.transformer) against the
JAX reference's make_paged_decoder(attention_impl="fused",
fused_impl="xla") on CONFIGS["tiny"] in f32, from the same parameters.

Logits agree within 1e-4 and the pools within 1e-5 at every written
position: the two compute the same function and differ only in the order
of their sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models.transformer import init_paged_kv_cache as j_init_pool
from ray_tpu.models.transformer import make_paged_decoder as j_make_paged_decoder
from ray_tpu_torch.models.transformer import CONFIGS, init_paged_kv_cache, make_paged_decoder
from ray_tpu_torch.weights import params_from_numpy

BT = 8
N_BLOCKS = 24


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
    nparams = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, nparams


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_params_from_numpy_round_trip(tiny):
    _, tcfg, _, nparams = tiny
    tparams = params_from_numpy(nparams, tcfg, device="cpu")
    got = dict(_leaves(tparams))
    want = dict(_leaves(nparams))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), w)

    bad = dict(nparams, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad, tcfg, device="cpu")
    missing = {k: v for k, v in nparams.items() if k != "unembed"}
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(missing, tcfg, device="cpu")


def test_params_from_numpy_reads_bfloat16_bits():
    cfg = dataclasses.replace(CONFIGS["tiny"], n_layers=1)
    jcfg = dataclasses.replace(J_CONFIGS["tiny"], n_layers=1)
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)),
        j_init_params(jax.random.PRNGKey(1), jcfg),
    )
    out = params_from_numpy(tree, cfg, device="cpu")
    want = np.asarray(tree["layers"]["wq"]).astype(np.float32)
    assert out["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["layers"]["wq"].float().numpy(), want)


class _Pair:
    """Both decoders over their own pools, driven with the same calls."""

    def __init__(self, tiny):
        jcfg, tcfg, jparams, nparams = tiny
        self.jparams = jparams
        self.tparams = params_from_numpy(nparams, tcfg, device="cpu")
        self.jpool = j_init_pool(jcfg, N_BLOCKS, BT)
        self.tpool = init_paged_kv_cache(tcfg, N_BLOCKS, BT, device="cpu")
        self.jpre, self.jdec, _, self.jcopy = j_make_paged_decoder(
            jcfg, block_tokens=BT, attention_impl="fused", fused_impl="xla"
        )
        self.tpre, self.tdec, self.tcopy = make_paged_decoder(tcfg, block_tokens=BT)
        self.key = jax.random.PRNGKey(0)

    def prefill(self, table, tokens, length, ctx_len, ctx_blocks):
        jtok, jlog, self.jpool = self.jpre(
            self.jparams, self.jpool, jnp.asarray(table), jnp.asarray(tokens),
            np.int32(length), np.int32(ctx_len), self.key, ctx_blocks,
        )
        ttok, tlog, self.tpool = self.tpre(
            self.tparams, self.tpool, torch.from_numpy(table),
            torch.from_numpy(tokens), length, ctx_len, None, ctx_blocks,
        )
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
        assert ttok.tolist() == np.asarray(jtok).tolist()
        return int(ttok[0])

    def decode(self, tables, tokens, positions, write_phys, write_off):
        jtok, jlog, self.jpool = self.jdec(
            self.jparams, self.jpool, jnp.asarray(tables), jnp.asarray(tokens),
            jnp.asarray(positions), jnp.asarray(write_phys),
            jnp.asarray(write_off), self.key,
        )
        args = [torch.from_numpy(a) for a in
                (tables, tokens, positions, write_phys, write_off)]
        ttok, tlog, self.tpool = self.tdec(self.tparams, self.tpool, *args, None)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
        assert ttok.tolist() == np.asarray(jtok).tolist()
        return ttok.numpy()

    def assert_pools_match(self, written):
        """`written`: (physical block, offset) pairs holding live K/V."""
        for name in ("k", "v"):
            jp = np.asarray(self.jpool[name])
            tp = self.tpool[name].numpy()
            for blk, off in written:
                np.testing.assert_allclose(
                    tp[:, blk, off], jp[:, blk, off], atol=1e-5, rtol=0,
                    err_msg=f"{name} block {blk} offset {off}",
                )


def _written(table, n_tokens):
    return [(int(table[p // BT]), p % BT) for p in range(n_tokens)]


def test_prefill_decode_and_copy_match_reference(tiny):
    pair = _Pair(tiny)
    rng = np.random.default_rng(0)
    nmax = 16
    tables = np.zeros((3, nmax), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [9, 6, 7, 8]
    # slot 0: one whole 13-token prompt padded to a 16-token bucket
    p0 = rng.integers(0, 256, size=13).astype(np.int32)
    tok0 = pair.prefill(tables[0], np.pad(p0, (0, 3))[None], 13, 0, 0)
    # slot 1: a 13-token prompt in two chunks, the boundary mid-block
    p1 = rng.integers(0, 256, size=13).astype(np.int32)
    pair.prefill(tables[1], np.pad(p1[:7], (0, 9))[None], 7, 0, 0)
    tok1 = pair.prefill(tables[1], np.pad(p1[7:], (0, 10))[None], 6, 7, 1)

    # three decode steps; slot 2 is inactive at position max_seq_len
    # (its rope row clamps) and writes into the null block
    tokens = np.array([tok0, tok1, 0], np.int32)
    positions = np.array([13, 13, 128], np.int32)
    for _ in range(3):
        wp = np.array([tables[0, positions[0] // BT],
                       tables[1, positions[1] // BT], 0], np.int32)
        wo = np.array([positions[0] % BT, positions[1] % BT, 0], np.int32)
        out = pair.decode(tables, tokens, positions, wp, wo)
        tokens = np.array([out[0], out[1], 0], np.int32)
        positions[:2] += 1
    pair.assert_pools_match(_written(tables[0], 16) + _written(tables[1], 16))

    src = np.array([1, 9], np.int32)
    dst = np.array([12, 13], np.int32)
    pair.jpool = pair.jcopy(pair.jpool, jnp.asarray(src), jnp.asarray(dst))
    pair.tpool = pair.tcopy(pair.tpool, torch.from_numpy(src), torch.from_numpy(dst))
    pair.assert_pools_match([(b, o) for b in (12, 13) for o in range(BT)])
    for name in ("k", "v"):
        t = pair.tpool[name]
        assert torch.equal(t[:, 12], t[:, 1]) and torch.equal(t[:, 13], t[:, 9])


def test_prefill_bucket_padded_past_max_seq_len(tiny):
    """A 5-token suffix at ctx 120 pads to a 16-token bucket: padded rows
    sit at positions 125..135, past max_seq_len (128) and past the table's
    last block, and must clamp exactly as JAX's gathers clamp."""
    pair = _Pair(tiny)
    rng = np.random.default_rng(1)
    table = np.arange(1, 17, dtype=np.int32)  # 16 blocks = 128 tokens
    prompt = rng.integers(0, 256, size=125).astype(np.int32)
    pair.prefill(table, prompt[None, :120], 120, 0, 0)
    pair.prefill(table, np.pad(prompt[120:], (0, 11))[None], 5, 120, 15)
    pair.assert_pools_match(_written(table, 125))


@pytest.mark.parametrize("variant", ["silu_gate", "gelu"])
def test_mlp_matches_reference(variant):
    from ray_tpu.models.transformer import _mlp as j_mlp
    from ray_tpu_torch.models.transformer import _mlp

    rng = np.random.default_rng(2)
    E, F = 32, 48
    h = rng.normal(size=(2, 3, E)).astype(np.float32)
    lp = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in (("w_gate", (E, F)), ("w_up", (E, F)), ("w_down", (F, E)))}
    if variant == "gelu":
        del lp["w_gate"]
    jcfg = dataclasses.replace(J_CONFIGS["tiny"], mlp_variant=variant,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(CONFIGS["tiny"], mlp_variant=variant,
                               dtype=torch.float32)
    want = j_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()},
                 jcfg, lambda x, *axes: x)
    got = _mlp(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in lp.items()},
               tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sampler_masks_vocab_pad():
    """Greedy picks what JAX's sampler picks with the padded ids masked;
    temperature sampling follows its generator and never emits a padded
    id."""
    from ray_tpu.models.transformer import _make_sampler as j_make_sampler
    from ray_tpu_torch.models.transformer import _make_sampler

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 40)).astype(np.float32)
    logits[:, -3:] += 10.0  # the padded tail would win unmasked
    greedy = _make_sampler(0.0, vocab_pad=3)(torch.from_numpy(logits))
    want = j_make_sampler(0.0, 3)(jnp.asarray(logits), jax.random.PRNGKey(0))
    assert greedy.tolist() == np.asarray(want).tolist()
    assert greedy.dtype == torch.int32

    sample = _make_sampler(1.0, vocab_pad=3)
    draws = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(7)
        draws.append(torch.stack([sample(torch.from_numpy(logits), gen)
                                  for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].max()) < 37 and len(set(draws[0].flatten().tolist())) > 4
