"""The port's ops (ray_tpu_torch.ops) against the JAX reference (ray_tpu.ops).

Inputs are made with numpy from a seed and handed to both packages; the
comparisons run in f32 on the CPU. The JAX paged attention runs both as
its XLA walk and as the Pallas kernel in interpret mode, as
tests/test_paged_attention.py runs it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import causal_attention as j_causal_attention
from ray_tpu.ops.norm import rms_norm as j_rms_norm
from ray_tpu.ops.rope import apply_rope as j_apply_rope
from ray_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.norm import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

j_pa = importlib.import_module("ray_tpu.ops.paged_attention")
t_pa = importlib.import_module("ray_tpu_torch.ops.paged_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: more intra-op threads only contend with the other
    # test workers for the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- norm, rope, dense


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    np.testing.assert_allclose(
        _np(rms_norm(_t(x), _t(scale))), _np(j_rms_norm(_j(x), _j(scale))),
        atol=1e-6, rtol=0,
    )


def test_rope_frequencies_match_reference():
    # f32 angles t * inv_freq: the two frameworks may round inv_freq one
    # ulp apart, which grows to ~max_len * 6e-8 in the angle
    cos, sin = rope_frequencies(16, 128, 10000.0)
    jcos, jsin = j_rope_frequencies(16, 128, 10000.0)
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=1e-5, rtol=0)


def test_apply_rope_positions_match_reference():
    """Same tables and positions into both; positions past the table end
    (padded prefill rows) clamp in the port as JAX's gather clamps."""
    rng = np.random.default_rng(1)
    cos, sin = (np.asarray(t) for t in j_rope_frequencies(16, 32, 500000.0))
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    positions = np.array([[0, 5, 9, 31, 32, 40], [3, 4, 5, 6, 7, 8]], np.int32)
    got = apply_rope(_t(x), _t(cos), _t(sin), positions=_t(positions))
    want = j_apply_rope(_j(x), _j(cos), _j(sin), positions=_j(positions))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def test_causal_attention_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    got = causal_attention(_t(q), _t(k), _t(v))
    want = j_causal_attention(_j(q), _j(k), _j(v))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


# ------------------------------------------------------- paged attention


def _pool_case(seed=0, b=3, Q=1, h=4, kv=2, d=16, bt=8, n_pool=12, n_max=5):
    """Slot 0 short (a mid-block position, a dead middle entry), slot 1 a
    full table, slot 2 fully dead."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, Q, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_pool, bt, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pool, bt, kv, d)).astype(np.float32)
    tables = np.zeros((b, n_max), np.int32)
    tables[0, :3] = [3, 0, 7]
    tables[1, :] = rng.choice(np.arange(1, n_pool), size=n_max, replace=False)
    positions = np.array([17, n_max * bt - 4 - Q, 0], np.int32)
    return q, kp, vp, tables, positions


# (name, Q, heads, kv heads, block_q, kv_len offset from positions or None)
_PA_CASES = [
    ("decode", 1, 4, 2, 16, None),
    ("multi_query_padded_tile", 5, 4, 2, 2, None),
    ("gqa_rep2_prefill", 6, 8, 4, 4, None),
    ("mha", 3, 2, 2, 16, None),
    ("kv_len_cap", 4, 4, 2, 2, 0),  # verify-style: kv_len = positions
]


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("name,Q,h,kv,block_q,kvl_off", _PA_CASES,
                         ids=[c[0] for c in _PA_CASES])
def test_paged_attention_plain_matches_reference(impl, name, Q, h, kv,
                                                 block_q, kvl_off):
    q, kp, vp, tables, positions = _pool_case(Q=Q, h=h, kv=kv)
    kv_len = None if kvl_off is None else positions + kvl_off
    jkw = dict(impl=impl, block_q=block_q, chunk_blocks=2)
    if impl == "kernel":
        jkw["interpret"] = True
    want = j_pa.paged_attention(
        _j(q), _j(kp), _j(vp), _j(tables), _j(positions),
        kv_len=None if kv_len is None else _j(kv_len), **jkw,
    )
    assert j_pa._LAST_IMPL == impl
    got = t_pa.paged_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(positions),
        kv_len=None if kv_len is None else _t(kv_len), chunk_blocks=2,
    )
    assert t_pa._LAST_IMPL == "plain"
    # only the summation order differs
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    assert not np.abs(_np(got)[2]).any()  # the fully dead slot is zeros


def test_paged_attention_3d_query_matches_reference():
    q, kp, vp, tables, positions = _pool_case(seed=3)
    want = j_pa.paged_attention(
        _j(q[:, 0]), _j(kp), _j(vp), _j(tables), _j(positions), impl="xla"
    )
    got = t_pa.paged_attention(
        _t(q[:, 0]), _t(kp), _t(vp), _t(tables), _t(positions)
    )
    assert got.shape == (3, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_partial_out_and_merge_match_reference():
    """Blocks split across two signed tables (as a sharded pool would
    split them): each half's (acc, m, l) triple matches JAX's, and the
    log-sum-exp merge equals the full attention."""
    q, kp, vp, tables, positions = _pool_case(seed=4, Q=3)
    signed = np.where(tables > 0, tables, -1).astype(np.int32)
    halves = []
    for keep in (np.arange(5) % 2 == 0, np.arange(5) % 2 == 1):
        tb = np.where(keep[None, :], signed, -1).astype(np.int32)
        got = t_pa.paged_attention(
            _t(q), _t(kp), _t(vp), _t(tb), _t(positions), signed_tables=True,
            partial_out=True,
        )
        want = j_pa.paged_attention(
            _j(q), _j(kp), _j(vp), _j(tb), _j(positions), signed_tables=True,
            partial_out=True, impl="kernel", interpret=True, block_q=2,
        )
        for g, w in zip(got, want):
            # a row with no live key in this half holds m = NEG_INF
            # (finite, -1e30) on both sides
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-6)
        halves.append(got)
    acc, m, l = (torch.stack(x) for x in zip(*halves))
    merged = t_pa.merge_partials(acc, m, l)
    jmerged = j_pa.merge_partials(
        jnp.asarray(_np(acc)), jnp.asarray(_np(m)), jnp.asarray(_np(l))
    )
    full = t_pa.paged_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(positions)
    )
    np.testing.assert_allclose(_np(merged), _np(full), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(merged), _np(jmerged), atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_path_without_launching():
    q, kp, vp, tables, positions = _pool_case(seed=5)
    before = t_pa.paged_attention.launches
    t_pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(positions))
    assert t_pa._LAST_IMPL == "plain"
    assert t_pa.paged_attention.launches == before
