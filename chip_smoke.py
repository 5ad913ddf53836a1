#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) once on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; each prints its wall seconds, and any failure exits
non-zero before the last line:

  (a) device   require CUDA; print the card's name and power limit
  (b) build    compile every kernel source from csrc/ (one nvcc each, in
               parallel): paged attention (B5) and flash attention (B1-B4)
  (c) check    each kernel against its plain PyTorch version, bf16 and
               f32: B5 at Llama-3-8B head shapes (H=32, KV=8, D=128, block
               64); B1-B4 at the train bench's attention shape (gpt2_125m
               heads, B=16, L=1024; fused and split routes), llama3_8b
               heads (L=2048, n_rep 4), causal=False and Lq != Lk
  (d) time     each kernel beside its bound, its plain version and one
               PyTorch library call, with CUDA events (median, L2 flushed);
               B1-B4 at the train bench's shape (B=16, H=12, L=1024, D=64)
  (e) serve    PagedDecodeEngine at full llama3_8b width (32 layers, random
               bf16 weights from a seeded generator) behind the port's
               ContinuousBatcher: 8 requests of 17-1000 prompt tokens, two
               sharing a 128-token prefix, 32 new tokens each; launch counts
               are zeroed just before and read just after
  (f) exact    a 2-layer f32 engine at llama3_8b widths: its greedy tokens
               equal the argmax of a teacher-forced dense re-forward
  (g) train    entry.train_bench(): gpt2_125m at full width and depth,
               batch 16 x 1024, flash attention + flash_min remat, 2
               warm-up and 10 timed steps on one seeded batch; flash launch
               counts zeroed just before: exactly 12 forward and 12 fused
               backward launches per step; then one profiled step
  (h) exact    a 2-layer f32 gpt2_125m-width model (seq 1024, batch 2):
               flash gradients equal dense ones on both backward routes;
               entry()'s forward once

The second-to-last lines are JSON: the serving and training numbers, the
card, and the kernel table. The last line is {"ok": true, "device":
{...}}. Imports nothing of JAX and nothing of the ray_tpu package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# published dense peaks (NVIDIA data sheets): memory bytes/s and bf16
# tensor-core operations/s, by the name nvidia-smi reports
_PEAKS = (
    ("H200", 4.8e12, 989e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100 PCIE", 2.0e12, 756e12),
    ("H100", 3.35e12, 989e12),  # SXM
)
BLOCK = 64
F32_TOL = (2e-5, 1e-5)   # atol, rtol: only the summation order differs
BF16_TOL = (1e-2, 1e-2)  # about one bf16 rounding of the output


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    up = name.upper()
    for key, bw, flops in _PEAKS:
        if key in up:
            return key, bw, flops
    raise RuntimeError(f"no published peaks for card {name!r}")


# --------------------------------------------------------------- (c), (d)


def make_pool_case(gen, B, Q, ctx, dtype, H=32, KV=8, D=128, dead_slot=False,
                   dead_entry=None):
    """Slots with contexts `ctx` (keys already in the pool before the Q
    queries); tables point at distinct random blocks of one pool."""
    dev = "cuda"
    nmax = max(-(-(c + Q) // BLOCK) for c in ctx)
    n_pool = B * nmax + 1
    kp = torch.randn((n_pool, BLOCK, KV, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_pool, BLOCK, KV, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, Q, H, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
    tables = perm[: B * nmax].reshape(B, nmax).to(torch.int32)
    for b, c in enumerate(ctx):
        tables[b, -(-(c + Q) // BLOCK):] = 0
    if dead_entry is not None:
        tables[dead_entry] = 0
    if dead_slot:
        tables[-1] = 0
    positions = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, positions


def check_close(got, want, tol, what):
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: kernel differs from plain version: max abs err "
            f"{err.max().item():.3e} at {bad.sum().item()} elements"
        )
    return err.max().item()


def check_paged_attention(pa, gen):
    """(c): every case in bf16 and f32; returns the max abs error per
    dtype."""
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        worst = 0.0
        # decode: B=8, contexts of 1..2048 tokens, a dead entry in slot 3,
        # slot 7 fully dead
        ctx = [0, 16, 63, 64, 299, 1023, 2047, 500]
        cases = [
            ("decode", make_pool_case(gen, 8, 1, ctx, dtype, dead_slot=True,
                                      dead_entry=(3, 0)), None),
            ("prefill Q=128", make_pool_case(gen, 1, 128, [0], dtype), None),
            ("prefill Q=512", make_pool_case(gen, 1, 512, [0], dtype), None),
            ("prefill Q=100 ragged at ctx 37",
             make_pool_case(gen, 2, 100, [37, 200], dtype), None),
            ("verify kv_len=positions",
             make_pool_case(gen, 8, 4, [5, 64, 130, 700, 1, 64, 90, 3], dtype),
             "cap"),
        ]
        for what, (q, kp, vp, tables, positions), cap in cases:
            Q = q.shape[1]
            kv_len = positions if cap else positions + Q
            got = pa.paged_attention(q, kp, vp, tables, positions, kv_len=kv_len)
            torch.cuda.synchronize()
            ptab = torch.where(tables > 0, tables, -1)
            want = pa._paged_attention_plain(
                q, kp, vp, ptab, positions, kv_len, q.shape[-1] ** -0.5, False, 8
            )
            worst = max(worst, check_close(got, want, tol, f"{what} {name}"))
        # partial_out on two halves of the decode tables + merge == full
        q, kp, vp, tables, positions = cases[0][1]
        signed = torch.where(tables > 0, tables, -1)
        even = (torch.arange(tables.shape[1], device="cuda") % 2 == 0)[None]
        parts = [
            pa.paged_attention(q, kp, vp, torch.where(keep, signed, -1),
                               positions, signed_tables=True, partial_out=True)
            for keep in (even, ~even)
        ]
        acc, m, l = (torch.stack(x) for x in zip(*parts))
        merged = pa.merge_partials(acc, m, l, out_dtype=dtype)
        full = pa.paged_attention(q, kp, vp, tables, positions)
        want = pa._paged_attention_plain(
            q, kp, vp, signed, positions, positions + 1, q.shape[-1] ** -0.5,
            False, 8,
        )
        worst = max(worst, check_close(merged, want, tol, f"partial+merge {name}"))
        worst = max(worst, check_close(full, want, tol, f"decode full {name}"))
        errs[name] = worst
        log(f"(c) paged_attention {name}: max abs err {worst:.3e} "
            f"(atol {tol[0]}, rtol {tol[1]})")
    return errs


def time_ms(fn, reps=30, warmup=3):
    """Median ms of one call, CUDA events around each, with 256 MB written
    between calls so each one finds the 50 MB L2 cold, as a serving step
    does after the weights stream through."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_paged_attention(pa, gen, bw, flops):
    """(d): kernel, plain version, bound and SDPA on the pre-gathered
    window, at the decode shape (B=8, ctx 1024) and prefill (Q=512)."""
    out = {}
    shapes = (
        ("decode", make_pool_case(gen, 8, 1, [1023] * 8, torch.bfloat16)),
        ("prefill", make_pool_case(gen, 1, 512, [0], torch.bfloat16)),
    )
    for what, (q, kp, vp, tables, positions) in shapes:
        B, Q, H, D = q.shape
        KV = kp.shape[2]
        kv_len = positions + Q
        ptab = torch.where(tables > 0, tables, -1)
        scale = D ** -0.5
        kernel = time_ms(lambda: pa.paged_attention(q, kp, vp, tables, positions))
        plain = time_ms(lambda: pa._paged_attention_plain(
            q, kp, vp, ptab, positions, kv_len, scale, False, 8))
        # the yardstick: SDPA over each slot's window gathered beforehand
        # (the gather is left out); every key of the window is live here
        W = int(kv_len.max())
        kw = kp[tables.long()].reshape(B, -1, KV, D)[:, :W].transpose(1, 2).contiguous()
        vw = vp[tables.long()].reshape(B, -1, KV, D)[:, :W].transpose(1, 2).contiguous()
        qh = q.transpose(1, 2).contiguous()
        library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kw, vw, is_causal=Q > 1, enable_gqa=True))
        # bound: each input read once, each output written once; the
        # operations this data needs (4 * H * D per visible query/key pair)
        live_blocks = int(((tables > 0) & (torch.arange(tables.shape[1],
                           device="cuda")[None] * BLOCK < kv_len[:, None])).sum())
        kv_bytes = live_blocks * BLOCK * KV * D * 2 * kp.element_size()
        io_bytes = 2 * q.numel() * q.element_size() + 3 * B * 4 + tables.numel() * 4
        pairs = sum(
            sum(min(int(p) + i + 1, int(k)) for i in range(Q))
            for p, k in zip(positions.tolist(), kv_len.tolist())
        )
        t_bytes = (kv_bytes + io_bytes) / bw * 1e3
        t_ops = 4 * H * D * pairs / flops * 1e3
        out[what] = {
            "ms": kernel, "plain_ms": plain, "library_ms": library,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": kv_bytes + io_bytes, "operations": 4 * H * D * pairs,
        }
        log(f"(d) paged_attention {what} {tuple(q.shape)}: kernel {kernel:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {library:.4f} ms, bound "
            f"{out[what]['bound_ms']:.4f} ms ({out[what]['bound_by']})")
    return out


# -------------------------------------------------- (c), (d): flash B1-B4

FLASH_KERNELS = {  # kernel -> the Pallas kernel it replaces (file:line)
    "flash_fwd": "ray_tpu/ops/flash_attention.py:41",
    "flash_dq": "ray_tpu/ops/flash_attention.py:160",
    "flash_dkv": "ray_tpu/ops/flash_attention.py:187",
    "flash_dqkv": "ray_tpu/ops/flash_attention.py:228",
}
# (what, B, Lq, Lk, H, KV, D, causal, routes): gpt2_125m heads at the
# train bench's shape (batch 16, seq 1024) on both routes, llama3_8b heads
# (n_rep 4), causal=False and Lq != Lk through every kernel
FLASH_CASES = (
    ("gpt2_125m heads, blocks 1024", 16, 1024, 1024, 12, 12, 64, True, ("fused",)),
    ("gpt2_125m heads, blocks 128", 16, 1024, 1024, 12, 12, 64, True, ("split",)),
    ("llama3_8b heads", 1, 2048, 2048, 32, 8, 128, True, ("split",)),
    ("causal=False", 1, 512, 512, 12, 12, 64, False, ("fused", "split")),
    ("Lq 384 != Lk 1024", 1, 384, 1024, 12, 12, 64, True, ("fused", "split")),
)
# |err| <= atol * max|want over the row| + rtol * |want|, a row being the
# last dimension (one token's D values; for lse, one head's sequence), so
# small rows deep in a causal sequence are held to their own scale: f32
# only reorders sums (dQ's atomics reorder them from run to run); bf16
# rounds p and dS where the kernel and the plain version see slightly
# different f32 values
FLASH_F32_TOL = (2e-5, 1e-5)
FLASH_BF16_TOL = (1e-2, 1e-2)


def flash_close(got, want, tol, what):
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol * want.abs().amax(-1, keepdim=True) + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: kernel differs from plain version: max abs err "
            f"{err.max().item():.3e} at {bad.sum().item()} elements"
        )
    return err.max().item()


def flash_inputs(gen, B, Lq, Lk, H, KV, D, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, H, Lq, D), rnd(B, KV, Lk, D), rnd(B, KV, Lk, D), rnd(B, H, Lq, D)


def check_flash(fa, gen):
    """(c): every case in f32 and bf16; each wrapper's result against the
    plain version. Returns {kernel: {dtype: max abs err}}."""
    errs = {k: {} for k in FLASH_KERNELS}
    for dtype, tol in ((torch.float32, FLASH_F32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        for what, B, Lq, Lk, H, KV, D, causal, routes in FLASH_CASES:
            q, k, v, do = flash_inputs(gen, B, Lq, Lk, H, KV, D, dtype)
            scale = D ** -0.5
            out, lse = fa._flash_forward_cuda(q, k, v, scale, causal)
            torch.cuda.synchronize()
            w_out, w_lse = fa._flash_forward_plain(q, k, v, scale, causal)
            e = max(flash_close(out, w_out, tol, f"flash_fwd out {what} {name}"),
                    flash_close(lse, w_lse, FLASH_F32_TOL, f"flash_fwd lse {what} {name}"))
            errs["flash_fwd"][name] = max(errs["flash_fwd"].get(name, 0.0), e)
            del w_out, w_lse
            want = fa._flash_backward_plain(q, k, v, out, lse, do, scale, causal)
            for route in routes:
                got = fa._flash_backward_cuda(q, k, v, out, lse, do, scale, causal,
                                              route == "fused")
                torch.cuda.synchronize()
                for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
                    kname = ("flash_dqkv" if route == "fused" else
                             "flash_dq" if grad == "dq" else "flash_dkv")
                    e = flash_close(g, w, tol, f"{kname} {grad} {what} {name}")
                    errs[kname][name] = max(errs[kname].get(name, 0.0), e)
                del got
            del q, k, v, do, out, lse, want
        log(f"(c) flash {name}: max abs err " + ", ".join(
            f"{k} {v[name]:.3e}" for k, v in errs.items())
            + f" (atol {tol[0]}*max|ref row|, rtol {tol[1]})")
    torch.cuda.empty_cache()
    return errs


def time_flash(fa, gen, bw, flops):
    """(d): B1, B2, B3 and B4 at the train bench's attention shape (B=16,
    H=12, L=1024, D=64, bf16, causal), each kernel launch alone beside its
    bound, the plain version and SDPA (forward for B1; the backward of a
    retained SDPA graph for the backward kernels). Also the whole backward
    of each route as the autograd Function runs it (Delta, scratch and
    casts included)."""
    B, H, L, D = 16, 12, 1024, 64
    dtype = torch.bfloat16
    q, k, v, do = flash_inputs(gen, B, L, L, H, H, D, dtype)
    scale = D ** -0.5
    out, lse = fa._flash_forward_cuda(q, k, v, scale, True)
    delta = fa._delta(out, do)
    bf = (float(scale), 1, 1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    runs = {
        "flash_fwd": lambda: fa._launch("flash_fwd_launch", q, k, v, out, lse,
                                        B, H, H, L, L, D, *bf),
        "flash_dq": lambda: fa._launch("flash_dq_launch", q, k, v, do, lse, delta,
                                       dq, B, H, H, L, L, D, *bf),
        "flash_dkv": lambda: fa._launch("flash_dkv_launch", q, k, v, do, lse, delta,
                                        dk, dv, B, H, H, L, L, D, *bf),
        "flash_dqkv": lambda: (dq_acc.zero_(), fa._launch(
            "flash_dqkv_launch", q, k, v, do, lse, delta, dq_acc, dk, dv,
            B, H, L, L, D, *bf)),
    }
    n_mm = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4, "flash_dqkv": 5}
    pairs = B * H * L * (L + 1) // 2  # visible causal query/key pairs
    e = q.element_size()
    in_fwd = 3 * q.numel() * e
    out_fwd = q.numel() * e + lse.numel() * 4
    in_bwd = 4 * q.numel() * e + 2 * lse.numel() * 4
    out_bytes = {"flash_fwd": out_fwd, "flash_dq": q.numel() * e,
                 "flash_dkv": 2 * q.numel() * e, "flash_dqkv": 3 * q.numel() * e}

    plain_fwd = time_ms(lambda: fa._flash_forward_plain(q, k, v, scale, True), reps=5)
    plain_bwd = time_ms(lambda: fa._flash_backward_plain(
        q, k, v, out, lse, do, scale, True), reps=5)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    graph_out = sdpa(*leaves, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(graph_out, leaves, do,
                                                  retain_graph=True))
    del graph_out, leaves
    whole = {
        "split": time_ms(lambda: fa._flash_backward_cuda(
            q, k, v, out, lse, do, scale, True, False)),
        "fused": time_ms(lambda: fa._flash_backward_cuda(
            q, k, v, out, lse, do, scale, True, True)),
    }
    res = {}
    for name, fn in runs.items():
        ms = time_ms(fn)
        fwd = name == "flash_fwd"
        n_bytes = (in_fwd if fwd else in_bwd) + out_bytes[name]
        n_ops = n_mm[name] * 2 * D * pairs
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops * 1e3
        res[name] = {
            "ms": ms, "plain_ms": plain_fwd if fwd else plain_bwd,
            "library_ms": lib_fwd if fwd else lib_bwd,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops,
        }
        log(f"(d) {name} B={B} H={H} L={L} D={D} bf16 causal: kernel {ms:.4f} ms, "
            f"plain {res[name]['plain_ms']:.4f} ms, sdpa {res[name]['library_ms']:.4f} ms, "
            f"bound {res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']})")
    log(f"(d) whole backward through the Function's route: split (B2+B3) "
        f"{whole['split']:.4f} ms, fused (B4) {whole['fused']:.4f} ms; "
        f"sdpa backward {lib_bwd:.4f} ms")
    for r in res.values():
        r["backward_split_ms"], r["backward_fused_ms"] = whole["split"], whole["fused"]
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- (g), (h)


def profile_train_step(step, state, data):
    """Where one train step's time goes: device ms by kernel class under
    torch.profiler, wall ms, and the device's idle share."""
    n = 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = step(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name, n_device = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            n_device += 1
    busy = sum(by_name.values()) / n
    classes = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("flash_attention" if "flash_" in low and "kernel" in low else
               "matmul" if any(w in low for w in ("gemm", "cutlass", "xmma", "gemv", "nvjet"))
               else "other")
        classes[key] += ms / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "steps": n, "wall_ms_per_step": wall_ms,
        "device_ops_per_step": n_device / n,
        "device_busy_ms_per_step": busy if by_name else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if by_name else "not measured",
        "device_ms_per_step_by_class": classes,
        "top_kernels_ms_per_step": {k[:90]: ms / n for k, ms in top},
    }
    log(f"(g) train step profile: {wall_ms:.1f} ms wall, {busy:.1f} ms on the "
        f"device in {n_device / n:.0f} kernels and copies; by class {classes}")
    return state, out


def train(fa, smi, flops):
    """(g): the main training path, entry.train_bench(), at full gpt2_125m
    width and depth; flash launch counts zeroed just before, read after."""
    from ray_tpu_torch import entry

    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    result = entry.train_bench("cuda", peak_flops=flops)
    launches = dict(fa.flash_attention.launches)
    n = entry.BENCH_WARMUP + entry.BENCH_STEPS
    cfg = entry.bench_config()
    losses = result["losses"]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    # the fused route ran, and flash_min kept the forward's output: one
    # forward and one fused backward launch per layer per step, nothing else
    assert launches == {"fwd": cfg.n_layers * n, "dq": 0, "dkv": 0,
                        "dqkv": cfg.n_layers * n}, launches
    torch.cuda.empty_cache()
    _cfg, state, step, data = entry.train_setup("cuda")
    state, _ = step(state, data)  # warm
    _state, profile = profile_train_step(step, state, data)
    del _state, state, step, data
    torch.cuda.empty_cache()
    result.update(launches_per_step={k: v / n for k, v in launches.items()},
                  profile=profile, card=smi)
    log(f"(g) gpt2_125m train, batch 16 x 1024, flash + flash_min: step median "
        f"{result['step_ms_median']:.2f} ms, {result['tokens_per_s']:.0f} tokens/s, "
        f"MFU {result['mfu']:.4f}, peak {result['peak_memory_gb']:.2f} GB; "
        f"losses {[round(x, 4) for x in losses]} ({smi})")
    return result, launches


def exact(fa):
    """(h): 2-layer f32 gpt2_125m-width model, seq 1024, batch 2: the
    gradients of the flash loss equal the dense loss's on both routes;
    then entry()'s forward once."""
    from ray_tpu_torch import entry
    from ray_tpu_torch.models.transformer import CONFIGS, init_params, make_loss_fn

    base = dataclasses.replace(CONFIGS["gpt2_125m"], n_layers=2, dtype=torch.float32,
                               remat_policy="flash_min")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = init_params(base, gen, device="cuda")
    rng = torch.Generator(device="cuda")
    rng.manual_seed(4)
    batch = {"tokens": torch.randint(0, base.vocab_size, (2, 1025), generator=rng,
                                     device="cuda", dtype=torch.int32)}

    def grads(cfg):
        leaves = {}
        for key, val in params.items():
            for sub, t in (val.items() if isinstance(val, dict) else [("", val)]):
                t.grad = None
                leaves[f"{key}/{sub}"] = t.requires_grad_()
        loss = make_loss_fn(cfg)(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: t.grad.clone() for k, t in leaves.items()}

    dense_loss, dense = grads(dataclasses.replace(base, attention="dense"))
    split_launches = 0
    worst = {}
    for blocks, route in ((1024, "fused"), (128, "split")):
        cfg = dataclasses.replace(base, attention="flash", flash_block_q=blocks,
                                  flash_block_k=blocks)
        for key in fa.flash_attention.launches:
            fa.flash_attention.launches[key] = 0
        loss, got = grads(cfg)
        n = dict(fa.flash_attention.launches)
        assert fa._LAST_IMPL == "kernel" and fa._LAST_ROUTE == route
        if route == "split":
            assert n["dq"] == n["dkv"] == base.n_layers and n["dqkv"] == 0, n
            split_launches = n["dq"]
        else:
            assert n["dqkv"] == base.n_layers and n["dq"] == n["dkv"] == 0, n
        # f32 only reorders sums (and dQ's atomics reorder them per run)
        assert abs(loss - dense_loss) <= 1e-5 * abs(dense_loss), (loss, dense_loss)
        err = 0.0
        for key, g in got.items():
            d = dense[key]
            rel = ((g - d).abs().max() / d.abs().max().clamp(min=1e-30)).item()
            assert rel <= 1e-4, (route, key, rel)
            err = max(err, rel)
        worst[route] = err
    log(f"(h) 2-layer f32 gpt2_125m width, seq 1024: flash grads equal dense "
        f"grads, max error relative to each leaf's max: fused {worst['fused']:.2e}, "
        f"split {worst['split']:.2e} (tolerance 1e-4); loss {dense_loss:.6f}")
    del params, dense, got
    torch.cuda.empty_cache()
    fn, args = entry.entry("cuda")
    logits = fn(*args)
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (4, 512, 50304), logits.shape
    assert torch.isfinite(logits.float()).all()
    log(f"(h) entry() forward: logits {tuple(logits.shape)} {logits.dtype}, finite")
    del fn, args, logits
    torch.cuda.empty_cache()
    return worst, split_launches


# ------------------------------------------------------------- (e), (f)


def dense_logits(params, cfg, tokens):
    """Teacher-forced dense forward of one sequence: logits [S, V]."""
    from ray_tpu_torch.models.transformer import _mlp
    from ray_tpu_torch.ops.attention import causal_attention
    from ray_tpu_torch.ops.norm import rms_norm
    from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

    cos, sin = rope_frequencies(cfg.d_head, len(tokens), cfg.rope_theta, device="cuda")
    x = params["embed"][tokens][None].to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm"])
        q = apply_rope(torch.einsum("bse,ehd->bshd", h, lp["wq"]), cos, sin)
        k = apply_rope(torch.einsum("bse,ekd->bskd", h, lp["wk"]), cos, sin)
        v = torch.einsum("bse,ekd->bskd", h, lp["wv"])
        x = x + torch.einsum("bshd,hde->bse", causal_attention(q, k, v), lp["wo"])
        x = x + _mlp(rms_norm(x, lp["mlp_norm"]), lp, cfg)
    return rms_norm(x, params["final_norm"])[0] @ params["unembed"].to(cfg.dtype)


def profile_decode(engine, prompts, steps=3):
    """Where a decode step's time goes: `steps` engine steps of all slots
    under torch.profiler. Returns wall ms per step, device-busy ms per
    step (kernels and copies on the one stream), the idle share, and
    device ms per step by kernel class and for the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slots = list(range(len(prompts)))
    for s, p in zip(slots, prompts):
        engine.admit(s, {"tokens": p, "max_new_tokens": steps + 2})
    engine.step(slots)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step(slots)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    for s in slots:
        engine.release(s)
    by_name, n_device = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            n_device += 1
    busy = sum(by_name.values()) / steps
    classes = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("paged_attention" if "paged_attention" in low else
               "matmul" if any(w in low for w in ("gemm", "cutlass", "xmma", "gemv", "nvjet"))
               else "other")
        classes[key] += ms / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "steps": steps, "slots": len(slots), "wall_ms_per_step": wall_ms,
        "device_ops_per_step": n_device / steps,
        "device_busy_ms_per_step": busy if by_name else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if by_name else "not measured",
        "device_ms_per_step_by_class": classes,
        "top_kernels_ms_per_step": {n[:90]: ms / steps for n, ms in top},
    }
    log(f"(e) decode profile: {wall_ms:.1f} ms/step wall, {busy:.1f} ms/step "
        f"on the device in {n_device / steps:.0f} kernels and copies; "
        f"by class {classes}")
    return out


def serve(pa, gen, card):
    """(e): the main path at full llama3_8b width behind the batcher."""
    from ray_tpu_torch.models.kv_paging import PagedDecodeEngine
    from ray_tpu_torch.models.transformer import CONFIGS, init_params
    from ray_tpu_torch.serve.batching import ContinuousBatcher

    cfg = CONFIGS["llama3_8b"]
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    engine = PagedDecodeEngine(cfg, params, device="cuda", max_seq_len=2048,
                               max_batch_size=8, block_tokens=BLOCK)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"(e) llama3_8b: {cfg.num_params() / 1e9:.2f}B params in bf16, "
        f"{cfg.n_layers} layers, pool {engine.num_blocks} blocks = "
        f"{engine.stats()['kv_pool_bytes'] / 1e9:.2f} GB, set up in {setup_s:.1f} s")

    # time every dispatch; keep a device-side flag that all logits are finite
    times = {"prefill": [], "decode": []}
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def timed(fn, sink):
        def call(*args):
            nonlocal finite
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            finite = finite & torch.isfinite(out[1]).all()
            return out
        return call

    rng = torch.Generator()
    rng.manual_seed(1)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    # warm-up outside the counted run (cuBLAS handles, allocator)
    engine.admit(0, {"tokens": tokens(80), "max_new_tokens": 3})
    engine.step([0])
    engine.release(0)
    plain_fns = engine._prefill, engine._decode_step
    engine._prefill = timed(engine._prefill, times["prefill"])
    engine._decode_step = timed(engine._decode_step, times["decode"])

    prefix = tokens(128)
    prompts = [tokens(1000), tokens(17), prefix + tokens(72),
               prefix + tokens(205), tokens(512), tokens(700), tokens(45),
               tokens(130)]
    new_tokens = 32
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    batcher = ContinuousBatcher(engine, batch_wait_timeout_s=0.05)
    t0 = time.perf_counter()
    try:
        streams = [batcher.submit(tokens=p, max_new_tokens=new_tokens)
                   for p in prompts]
        outs = [list(s) for s in streams]
    finally:
        batcher.close()
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    after = engine.stats()
    engine._prefill, engine._decode_step = plain_fns

    dispatches = (after["prefill_chunks"] - before["prefill_chunks"]
                  + after["decode_steps"] - before["decode_steps"])
    assert all(len(o) == new_tokens for o in outs), [len(o) for o in outs]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert bool(finite), "non-finite logits in the serving run"
    assert after["prefix_hits"] - before["prefix_hits"] >= 1, after
    assert launches == cfg.n_layers * dispatches, (launches, dispatches)
    assert launches > 0

    profile = profile_decode(engine, prompts)

    # a dense bf16 re-forward of the prefix-hit request, for information:
    # bf16 rounds at other places on the two paths, so argmax may differ
    # where the top two logits sit within bf16 noise
    seq = torch.tensor(prompts[3] + outs[3][:-1], device="cuda")
    dense = dense_logits(params, cfg, seq)[len(prompts[3]) - 1:].argmax(-1)
    agree = (dense.cpu() == torch.tensor(outs[3])).float().mean().item()

    gen_tokens = sum(len(o) for o in outs)
    result = {
        "model": "llama3_8b", "layers": cfg.n_layers, "dtype": "bfloat16",
        "requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
        "new_tokens_each": new_tokens,
        "prefill_dispatches": len(times["prefill"]),
        "prefill_ms_median": statistics.median(times["prefill"]),
        "prefill_ms_max": max(times["prefill"]),
        "decode_steps": len(times["decode"]),
        "decode_step_ms_median": statistics.median(times["decode"]),
        "tokens_per_s": gen_tokens / wall, "wall_s": wall,
        "prefix_hits": after["prefix_hits"] - before["prefix_hits"],
        "attention_launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "bf16_dense_argmax_agreement": agree,
        "decode_profile": profile,
        "card": card,
    }
    log(f"(e) served {len(prompts)} requests: prefill median "
        f"{result['prefill_ms_median']:.1f} ms over {result['prefill_dispatches']} "
        f"dispatches, decode step median {result['decode_step_ms_median']:.1f} ms "
        f"over {result['decode_steps']} steps, {result['tokens_per_s']:.1f} tok/s "
        f"({card})")
    return result, launches


def greedy_identity(gen):
    """(f): 2 layers at llama3_8b widths in f32, engine vs dense."""
    from ray_tpu_torch.models.kv_paging import PagedDecodeEngine
    from ray_tpu_torch.models.transformer import CONFIGS, init_params

    cfg = dataclasses.replace(CONFIGS["llama3_8b"], n_layers=2, dtype=torch.float32)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    engine = PagedDecodeEngine(cfg, params, device="cuda", max_seq_len=2048,
                               max_batch_size=3, block_tokens=BLOCK)
    rng = torch.Generator()
    rng.manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (100, 300, 65)]
    outs = {}
    for s, p in enumerate(prompts):
        tok, _ = engine.admit(s, {"tokens": p, "max_new_tokens": 16})
        outs[s] = [tok]
    for _ in range(15):
        for s, (tok, _) in engine.step([0, 1, 2]).items():
            outs[s].append(tok)
    checked = 0
    for s, p in enumerate(prompts):
        seq = torch.tensor(p + outs[s][:-1], device="cuda")
        dense = dense_logits(params, cfg, seq)[len(p) - 1:].argmax(-1).cpu().tolist()
        assert dense == outs[s], (s, dense, outs[s])
        checked += len(dense)
    log(f"(f) greedy identity, 2-layer f32 engine vs dense re-forward: "
        f"{checked} tokens equal")
    return checked


def main() -> int:
    # (a) device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    peak_key, bw, flops = card_peaks(name)
    log(f"(a) {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peaks used: {peak_key} {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s bf16")

    # (b) build every kernel, one nvcc each, started together
    t0 = time.perf_counter()
    _kernels.build(_kernels.SIGNATURES)
    log(f"(b) built {sorted(_kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f} s")
    for kname, text in sorted(_kernels.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {kname}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    phase_s = {}

    def phase(key, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[key] = time.perf_counter() - t
        log(f"({key}) {phase_s[key]:.1f} s")
        return out

    errs = phase("c", check_paged_attention, pa, gen)
    flash_errs = phase("c flash", check_flash, fa, gen)
    timing = phase("d", time_paged_attention, pa, gen, bw, flops)
    flash_timing = phase("d flash", time_flash, fa, gen, bw, flops)
    serving, launches = phase("e", serve, pa, gen, smi)
    torch.cuda.empty_cache()
    phase("f", greedy_identity, gen)
    training, train_launches = phase("g", train, fa, smi, flops)
    exact_errs, split_launches = phase("h", exact, fa)

    dec, pre = timing["decode"], timing["prefill"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:108",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_err_bf16": errs["bf16"], "max_err_f32": errs["f32"],
        "ms": dec["ms"], "kernel_ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode B=8 Q=1 ctx=1024 H=32 KV=8 D=128 bf16",
        "prefill_ms": pre["ms"], "prefill_plain_ms": pre["plain_ms"],
        "prefill_bound_ms": pre["bound_ms"], "prefill_bound_by": pre["bound_by"],
        "prefill_library_ms": pre["library_ms"],
        "prefill_shape": "prefill B=1 Q=512 ctx=0 H=32 KV=8 D=128 bf16",
    }]
    # B1 and B4 run on the training path (g); B2 and B3 run on the split
    # route, which (h) drives (blocks of 128)
    flash_launches = {
        "flash_fwd": (train_launches["fwd"], "(g) train_bench"),
        "flash_dqkv": (train_launches["dqkv"], "(g) train_bench"),
        "flash_dq": (split_launches, "(h) split route, 2 layers"),
        "flash_dkv": (split_launches, "(h) split route, 2 layers"),
    }
    for kname, replaces in FLASH_KERNELS.items():
        t, e = flash_timing[kname], flash_errs[kname]
        n, where = flash_launches[kname]
        assert n > 0, (kname, n)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": n, "launches_in": where,
            "max_abs_err": max(e.values()),
            "max_err_bf16": e["bf16"], "max_err_f32": e["f32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "backward_split_ms": t["backward_split_ms"],
            "backward_fused_ms": t["backward_fused_ms"],
            "shape": "B=16 H=12 L=1024 D=64 bf16 causal",
        })
    training["exact_grad_rel_err"] = exact_errs
    training["phase_s"] = phase_s
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
