"""The port's training ops against the JAX package: head-major rope and
dense attention, the losses, and flash attention (out, lse and the three
gradients on both backward routes).

Inputs are made with numpy from a seed and handed to both packages; the
comparisons run in f32 on the CPU, where JAX's Pallas flash kernels run
in interpret mode (as tests/test_flash_attention.py runs them) and the
port runs its plain versions. Tolerances: f32 only reorders sums, so
1e-5 for activations and 1e-4 for gradients and losses.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import causal_attention_bhsd as j_attn_bhsd
from ray_tpu.ops.losses import blockwise_softmax_cross_entropy as j_blockwise
from ray_tpu.ops.losses import softmax_cross_entropy_with_int_labels as j_ce
from ray_tpu.ops.rope import apply_rope_bhsd as j_rope_bhsd
from ray_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from ray_tpu_torch.ops import flash_attention as t_fa
from ray_tpu_torch.ops.attention import causal_attention_bhsd
from ray_tpu_torch.ops.losses import (
    blockwise_softmax_cross_entropy,
    softmax_cross_entropy_with_int_labels,
)
from ray_tpu_torch.ops.rope import apply_rope_bhsd

# ray_tpu.ops exports the function under the module's name
j_fa = importlib.import_module("ray_tpu.ops.flash_attention")

ACT_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: more intra-op threads only contend with the other
    # test workers for the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------ rope, dense, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_bhsd_matches_reference(dtype):
    """In the input dtype, as JAX computes it: bf16 rounds at the same
    places, so bf16 agrees to within one bf16 rounding of the output."""
    rng = np.random.default_rng(0)
    cos, sin = (np.asarray(t) for t in j_rope_frequencies(16, 32))
    x = rng.normal(size=(2, 3, 20, 16)).astype(np.float32)
    want = j_rope_bhsd(jnp.asarray(x, dtype), jnp.asarray(cos), jnp.asarray(sin))
    got = apply_rope_bhsd(_t(x).to(getattr(torch, dtype)), _t(cos), _t(sin))
    assert got.dtype == getattr(torch, dtype)
    tol = ACT_TOL if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_causal_attention_bhsd_matches_reference(causal):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    got = causal_attention_bhsd(_t(q), _t(k), _t(v), causal=causal)
    want = j_attn_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ACT_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_value_and_grad_match_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3) if masked else None
    jl, jw = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                  where=None if mask is None else jnp.asarray(mask))
    jg = jax.grad(lambda x: j_ce(x, jnp.asarray(labels),
                                 where=None if mask is None else jnp.asarray(mask))[0])(
        jnp.asarray(logits))
    x = _t(logits, grad=True)
    loss, w = softmax_cross_entropy_with_int_labels(
        x, _t(labels), where=None if mask is None else _t(mask))
    loss.backward()
    np.testing.assert_allclose(_np(loss), np.asarray(jl), **GRAD_TOL)
    assert float(w) == float(jw)
    np.testing.assert_allclose(_np(x.grad), np.asarray(jg), **GRAD_TOL)


@pytest.mark.parametrize("seq,chunk", [(12, 4), (11, 4), (8, 16)])
def test_blockwise_cross_entropy_equals_dense_and_reference(seq, chunk):
    """Chunked (padding included when chunk does not divide seq) equals
    the dense loss of the full logits, in value and in both gradients,
    and equals JAX's blockwise loss."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, seq, 16)).astype(np.float32)
    u = rng.normal(size=(16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, seq)).astype(np.int32)
    mask = rng.random((2, seq)) > 0.2
    xt, ut = _t(x, grad=True), _t(u, grad=True)
    loss, total = blockwise_softmax_cross_entropy(xt, ut, _t(labels),
                                                  where=_t(mask), chunk=chunk)
    loss.backward()
    xd, ud = _t(x, grad=True), _t(u, grad=True)
    dense, dtotal = softmax_cross_entropy_with_int_labels(
        torch.einsum("bsd,dv->bsv", xd, ud), _t(labels), where=_t(mask))
    dense.backward()
    np.testing.assert_allclose(_np(loss), _np(dense), **GRAD_TOL)
    assert float(total) == float(dtotal)
    np.testing.assert_allclose(_np(xt.grad), _np(xd.grad), **GRAD_TOL)
    np.testing.assert_allclose(_np(ut.grad), _np(ud.grad), **GRAD_TOL)
    jl, _ = j_blockwise(jnp.asarray(x), jnp.asarray(u), jnp.asarray(labels),
                        where=jnp.asarray(mask), chunk=chunk)
    np.testing.assert_allclose(_np(loss), np.asarray(jl), **GRAD_TOL)


# ----------------------------------------------------------- flash


# (name, B, Lq, Lk, H, KV, D, block_q, block_k, causal)
_FLASH_CASES = [
    ("fused_one_block", 1, 64, 64, 2, 2, 16, 64, 64, True),
    ("split_gqa_4x4_blocks", 1, 128, 128, 8, 2, 16, 32, 32, True),
    ("split_one_block_gqa", 1, 32, 32, 4, 2, 16, 64, 64, True),
    ("non_causal", 1, 128, 128, 2, 2, 16, 64, 64, False),
    ("lq_ne_lk", 2, 64, 128, 2, 1, 16, 32, 32, True),
]


def _flash_inputs(seed, B, Lq, Lk, H, KV, D):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, Lq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, KV, Lk, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, KV, Lk, D)) * 0.5).astype(np.float32)
    w = rng.normal(size=(B, H, Lq, D)).astype(np.float32)  # the cotangent
    return q, k, v, w


@pytest.mark.parametrize("name,B,Lq,Lk,H,KV,D,bq,bk,causal", _FLASH_CASES,
                         ids=[c[0] for c in _FLASH_CASES])
def test_flash_matches_reference(name, B, Lq, Lk, H, KV, D, bq, bk, causal):
    q, k, v, w = _flash_inputs(4, B, Lq, Lk, H, KV, D)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    scale = D ** -0.5

    def j_loss(q, k, v):
        out = j_fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, layout="bhsd")
        return jnp.sum(out * jnp.asarray(w))

    jout = j_fa.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                block_k=bk, layout="bhsd")
    _, jlse = j_fa._flash_forward(jq, jk, jv, scale, causal, min(bq, Lq),
                                  min(bk, Lk), True)
    jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = t_fa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                               block_k=bk, layout="bhsd")
    assert t_fa._LAST_IMPL == "plain"
    _, lse = t_fa._flash_forward(_t(q), _t(k), _t(v), scale, causal)
    out.backward(_t(w))
    # JAX's rule (_flash_backward :275) on the clamped blocks
    nq, nk = Lq // min(bq, Lq), Lk // min(bk, Lk)
    assert t_fa._LAST_ROUTE == ("fused" if nq == nk == 1 and H == KV else "split")
    np.testing.assert_allclose(_np(out), np.asarray(jout), **ACT_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), **ACT_TOL)
    for tname, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape, tname  # dk/dv stay [B, KV, L, D]
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), err_msg=tname,
                                   **GRAD_TOL)


def test_flash_bshd_layout_and_ragged_fallback():
    """The default [B, L, H, D] layout gives the transposed head-major
    result; a sequence the blocks do not tile runs the dense path."""
    q, k, v, _ = _flash_inputs(5, 1, 100, 100, 2, 2, 16)
    perm = (0, 2, 1, 3)
    got = t_fa.flash_attention(_t(q.transpose(perm)), _t(k.transpose(perm)),
                               _t(v.transpose(perm)), block_q=64, block_k=64)
    assert t_fa._LAST_IMPL == "dense"
    want = j_fa.flash_attention(*(jnp.asarray(a.transpose(perm)) for a in (q, k, v)),
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ACT_TOL)
    q, k, v, _ = _flash_inputs(6, 1, 64, 64, 2, 2, 16)
    got = t_fa.flash_attention(_t(q.transpose(perm)), _t(k.transpose(perm)),
                               _t(v.transpose(perm)), block_q=32, block_k=32)
    assert t_fa._LAST_IMPL == "plain"
    want = causal_attention_bhsd(_t(q), _t(k), _t(v)).transpose(1, 2)
    np.testing.assert_allclose(_np(got), _np(want), **ACT_TOL)


def test_flash_heads_must_divide():
    q = torch.zeros(1, 3, 64, 16)
    k = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="multiple"):
        t_fa.flash_attention(q, k, k, layout="bhsd")


def test_flash_on_cpu_launches_nothing():
    q, k, v, w = _flash_inputs(7, 1, 64, 64, 2, 2, 16)
    before = dict(t_fa.flash_attention.launches)
    tq = _t(q, grad=True)
    t_fa.flash_attention(tq, _t(k), _t(v), layout="bhsd").backward(_t(w))
    assert t_fa._LAST_IMPL == "plain"
    assert t_fa.flash_attention.launches == before
