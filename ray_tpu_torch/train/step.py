"""Train step on one device (port of the single-device path of
ray_tpu/train/step.py).

`default_optimizer` is written out to optax's formulas, not to
`torch.optim`'s, so a trajectory matches the JAX package step for step:
clip_by_global_norm(1.0), then AdamW (b1 0.9, b2 0.95, eps 1e-8, bias
correction, decay on every leaf), scaled by
warmup_cosine_decay_schedule(0, lr, warmup, 10000, 0.1 * lr), whose lr at
count 0 is 0. Where JAX donates the state and returns a new one, the port
updates the parameters and the optimizer moments IN PLACE (no second
copy of either) and returns a new TrainState around the same tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models.transformer import TransformerConfig, make_loss_fn


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in _leaves(tree)))


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay, mu_dtype)) as init/update over dicts of tensors.
    State: {"count": updates done, "mu": first moments in mu_dtype (the
    params' dtype when None), "nu": second moments in the params' dtype}.
    """

    b1, b2, eps = 0.9, 0.95, 1e-8
    max_norm = 1.0

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr = schedule
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": _tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                            params),
            "nu": _tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, grads, state, params, g_norm: torch.Tensor):
        """Apply one update to `params` and `state` in place, `g_norm`
        being `global_norm(grads)`; returns the new state dict (same
        tensors, count + 1)."""
        # clip_by_global_norm: (t / norm) * max_norm, only when
        # norm >= max_norm, without any epsilon
        clip = g_norm >= self.max_norm
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.lr(state["count"])
        for g, p, mu, nu in zip(_leaves(grads), _leaves(params),
                                _leaves(state["mu"]), _leaves(state["nu"])):
            g = torch.where(clip, (g / g_norm.to(g.dtype)) * self.max_norm, g)
            # JAX's weakly typed b1 takes mu's dtype (0.8984375 for a
            # bf16 mu), and the jitted product is exact in f32
            b1 = float(torch.tensor(self.b1, dtype=mu.dtype))
            mu_new = (1 - self.b1) * g + b1 * mu.float()
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu_new / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_((-lr) * u)
            mu.copy_(mu_new)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then cosine down to
    end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100,
                      mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with warmup-cosine, as JAX's `default_optimizer` (:230)."""
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, 10000, lr * 0.1)
    return AdamW(sched, weight_decay, mu_dtype=mu_dtype)


def init_train_state(params, optimizer: AdamW) -> TrainState:
    """Step 0 around `params` (f32 masters, updated in place by the step)."""
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(cfg: TransformerConfig, optimizer: AdamW):
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm",
    "step"}). `grad_norm` is the global norm of the gradients before the
    clip. `loss` and `grad_norm` stay on the device (no host sync).
    Gradients are taken in the params' dtype (JAX's
    compute_dtype_grads=False)."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch):
        params = state.params
        diff = _tree_map(lambda p: p.requires_grad_(), params)
        loss = loss_fn(diff, batch)
        leaves = _leaves(diff)
        grads_flat = torch.autograd.grad(loss, leaves)
        it = iter(grads_flat)
        grads = _tree_map(lambda _: next(it), diff)
        gnorm = global_norm(grads)
        opt_state = optimizer.update_(grads, state.opt_state, params, gnorm)
        new = TrainState(state.step + 1, params, opt_state)
        return new, {"loss": loss.detach(), "grad_norm": gnorm, "step": new.step}

    return train_step
