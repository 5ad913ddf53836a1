"""Entry points of the training slice: the counterparts of
`__graft_entry__.entry()` and of `bench.py main_raw`'s accelerator branch.

Both run on the CUDA device unless the caller passes `device="cpu"`, and
raise when CUDA is absent.

    from ray_tpu_torch.entry import entry, train_bench
    fn, args = entry()            # gpt2_125m forward, tokens [4, 512]
    logits = fn(*args)
    result = train_bench()        # gpt2_125m train steps, batch 16 x 1024
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .models.transformer import CONFIGS, init_params, make_forward
from .train.step import default_optimizer, init_train_state, make_train_step

# published dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet)
H100_BF16_FLOPS = 989e12
# main_raw's shape and step counts
BENCH_BATCH, BENCH_SEQ = 16, 1024
BENCH_WARMUP, BENCH_STEPS = 2, 10


def entry(device=None):
    """Returns (fn, example_args): the gpt2_125m forward (dense attention,
    bf16 compute, random f32 masters from seed 0) and (params, tokens
    [4, 512] of zeros). fn runs without grad."""
    dev = resolve_device(device)
    cfg = CONFIGS["gpt2_125m"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    forward = make_forward(cfg)

    def fn(params, tokens):
        with torch.no_grad():
            return forward(params, tokens)

    tokens = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    return fn, (params, tokens)


def bench_config():
    """main_raw's accelerator configuration: gpt2_125m with flash
    attention (fused single-block backward at seq 1024), the flash_min
    remat policy and unrolled layers."""
    return dataclasses.replace(CONFIGS["gpt2_125m"], attention="flash",
                               remat_policy="flash_min", scan_layers=False)


def train_setup(device=None, *, cfg=None, batch: int = BENCH_BATCH,
                seq: int = BENCH_SEQ):
    """(cfg, state, train_step, batch_data) for `cfg` (bench_config() when
    None): random f32 masters from a generator seeded 0,
    default_optimizer(lr=1e-3, warmup=10), and one batch of random tokens
    [batch, seq + 1] (numpy seed 0) with an all-ones mask, as main_raw
    builds them."""
    dev = resolve_device(device)
    cfg = cfg or bench_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    opt = default_optimizer(lr=1e-3, warmup=10)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    data = {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
        ).to(dev),
        "mask": torch.ones((batch, seq + 1), dtype=torch.int32, device=dev),
    }
    return cfg, state, step, data


def train_bench(device=None, *,
                peak_flops: float = H100_BF16_FLOPS) -> Dict[str, Any]:
    """BENCH_WARMUP then BENCH_STEPS timed train steps of train_setup()'s
    configuration on its one batch, each timed by the host clock around
    work that ends in a device sync. Returns per-step ms and their median,
    tokens/s, MFU against `peak_flops` (the card's bf16 peak; FLOPs per
    token from flops_per_token + attention_flops_per_token), peak device
    memory, and every step's loss and grad norm (warm-up steps first)."""
    cfg, state, step, data = train_setup(device)
    batch, seq = BENCH_BATCH, BENCH_SEQ
    warmup, steps = BENCH_WARMUP, BENCH_STEPS
    dev = data["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, times = [], [], []
    for i in range(warmup + steps):
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, data)
        sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    step_ms = statistics.median(times)
    tokens_per_s = batch * seq / (step_ms / 1e3)
    flops_per_token = cfg.flops_per_token() + cfg.attention_flops_per_token(seq)
    on_card = dev.type == "cuda"
    return {
        "model": "gpt2_125m", "layers": cfg.n_layers, "batch": batch, "seq": seq,
        "attention": cfg.attention, "remat_policy": cfg.remat_policy,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "warmup_steps": warmup, "timed_steps": steps,
        "step_ms": times, "step_ms_median": step_ms,
        "tokens_per_s": tokens_per_s, "flops_per_token": flops_per_token,
        # device metrics exist only for a run on the card
        "mfu": tokens_per_s * flops_per_token / peak_flops if on_card else None,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if on_card else None),
        "losses": [float(x) for x in losses],
        "grad_norms": [float(x) for x in norms],
    }
