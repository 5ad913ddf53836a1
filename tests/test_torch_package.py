"""Package rules of the PyTorch/CUDA port: ray_tpu_torch (and
chip_smoke.py) import neither jax nor ray_tpu, entry points default to
CUDA and refuse to fall back to the CPU, and CPU tensors take the plain
paged-attention path."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ray_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py")
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: more intra-op threads only contend with the other
    # test workers for the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_import_leaves_jax_and_ray_tpu_out():
    # modules the interpreter's site hooks load before ours do not count
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ray_tpu_torch.serve.batching" in MODULES


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_ray_tpu(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_refuses_cpu_fallback(no_cuda):
    from ray_tpu_torch.models.kv_paging import PagedDecodeEngine
    from ray_tpu_torch.models.transformer import CONFIGS, init_params

    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeEngine(CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(CONFIGS["tiny"])
    eng = PagedDecodeEngine(CONFIGS["tiny"], device="cpu", max_batch_size=1)
    assert eng.device.type == "cpu" and eng.pool["k"].device.type == "cpu"


def test_training_entry_points_default_to_cuda(no_cuda):
    """entry(), train_bench() and train_setup() need CUDA unless asked for
    the CPU; on the CPU the train step runs flash attention's plain path
    and launches no kernel."""
    import dataclasses

    from ray_tpu_torch import entry
    from ray_tpu_torch.models.transformer import CONFIGS
    from ray_tpu_torch.ops import flash_attention as fa

    for fn in (entry.entry, entry.train_bench, entry.train_setup):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    cfg = dataclasses.replace(CONFIGS["tiny"], attention="flash",
                              remat_policy="flash_min", dtype=torch.float32)
    cfg, state, step, data = entry.train_setup("cpu", cfg=cfg, batch=2, seq=16)
    before = dict(fa.flash_attention.launches)
    state, metrics = step(state, data)
    assert fa._LAST_IMPL == "plain" and fa._LAST_ROUTE == "split"
    assert fa.flash_attention.launches == before
    assert metrics["step"] == 1 and torch.isfinite(metrics["loss"])
    assert state.params["embed"].device.type == "cpu"


def test_paged_attention_on_cpu_reports_the_plain_path():
    pa = importlib.import_module("ray_tpu_torch.ops.paged_attention")
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(5, 8, 2, 16)).astype(np.float32))
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, pool, pool, tables, torch.tensor([9, 3]))
    assert pa._LAST_IMPL == "plain"
    assert pa.paged_attention.launches == before
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_kernel_build_directory_is_ignored_by_git():
    from ray_tpu_torch.ops import _kernels

    assert _kernels.BUILD_DIR == ROOT / "build" / "kernels"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
