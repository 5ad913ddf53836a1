"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; run them
on the card with `python -m pytest tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.kv_paging import PagedDecodeEngine
from ray_tpu_torch.models.transformer import TransformerConfig, init_params
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, b, Q, h, kv, d, bt, nmax, dtype, dev):
    rng = np.random.default_rng(seed)
    n_pool = b * nmax + 1
    q = torch.from_numpy(rng.normal(size=(b, Q, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(n_pool, bt, kv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n_pool, bt, kv, d)).astype(np.float32))
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    tables = perm[: b * nmax].reshape(b, nmax).copy()
    tables[0, 1] = 0  # a dead entry mid-window
    tables[-1, :] = 0  # a fully dead slot
    positions = rng.integers(0, nmax * bt - Q, size=b).astype(np.int32)
    to = lambda t: t.to(dev, dtype)  # noqa: E731
    return (to(q), to(kp), to(vp), torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,h,kv,d,bt", [
    (1, 8, 2, 128, 16), (7, 8, 2, 64, 16), (40, 4, 4, 128, 64),
    (33, 32, 8, 128, 64),
])
def test_kernel_matches_plain(cuda, dtype, Q, h, kv, d, bt):
    q, kp, vp, tables, positions = _case(0, 3, Q, h, kv, d, bt, 6, dtype, cuda)
    for kv_len in (None, positions):  # decode/prefill, and the verify cap
        before = pa.paged_attention.launches
        got = pa.paged_attention(q, kp, vp, tables, positions, kv_len=kv_len)
        assert pa._LAST_IMPL == "kernel"
        assert pa.paged_attention.launches == before + 1
        want = pa._paged_attention_plain(
            q, kp, vp, torch.where(tables > 0, tables, -1), positions,
            positions + Q if kv_len is None else kv_len, d ** -0.5, False, 8,
        )
        torch.cuda.synchronize()
        tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else \
            dict(atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_partial_out_merges_to_full(cuda):
    q, kp, vp, tables, positions = _case(1, 3, 5, 8, 2, 128, 16, 6,
                                          torch.float32, cuda)
    signed = torch.where(tables > 0, tables, -1)
    parts = []
    for keep in (torch.arange(6, device=cuda) < 3, torch.arange(6, device=cuda) >= 3):
        tb = torch.where(keep[None], signed, -1)
        parts.append(pa.paged_attention(q, kp, vp, tb, positions,
                                        signed_tables=True, partial_out=True))
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    full = pa.paged_attention(q, kp, vp, tables, positions)
    torch.testing.assert_close(pa.merge_partials(acc, m, l), full,
                               atol=2e-5, rtol=1e-5)


def test_engine_on_cuda_matches_cpu(cuda):
    """Greedy tokens of a small f32 model (head_dim 64, the kernel's
    smallest) on the card equal the same engine's on the CPU."""
    cfg = TransformerConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=64, d_ff=256, max_seq_len=128, dtype=torch.float32,
    )
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 19, 40)]
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        eng = PagedDecodeEngine(cfg, p, device=dev, max_batch_size=3,
                                block_tokens=16)
        got = {}
        for s, pr in enumerate(prompts):
            got[s] = [eng.admit(s, {"tokens": pr, "max_new_tokens": 12})[0]]
        for _ in range(11):
            for s, (tok, _) in eng.step([0, 1, 2]).items():
                got[s].append(tok)
        outs.append(got)
    assert outs[0] == outs[1]
