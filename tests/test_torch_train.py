"""The port's training slice against the JAX package: the forward and
loss of `make_forward`/`make_loss_fn` on both attentions, gradients under
every ported remat policy, the optimizer's schedule, and a 5-step loss
and grad-norm trajectory of `make_train_step` against JAX's train step on
a one-device mesh.

Parameters are JAX's (init_params from PRNGKey 0) handed over as numpy;
tokens are made with numpy from a seed. Everything runs in f32 on the
CPU, where JAX's Pallas flash kernels run in interpret mode and the port
runs its plain versions. Tolerances: f32 only reorders sums, so 1e-5 for
activations and 1e-4 for gradients, losses and grad norms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models.transformer import make_forward as j_make_forward
from ray_tpu.models.transformer import make_loss_fn as j_make_loss_fn
from ray_tpu.parallel import PRESET_RULES, MeshSpec, build_mesh
from ray_tpu.train.step import default_optimizer as j_default_optimizer
from ray_tpu.train.step import make_sharded_init as j_make_sharded_init
from ray_tpu.train.step import make_train_step as j_make_train_step
from ray_tpu_torch.models.transformer import CONFIGS, make_forward, make_loss_fn
from ray_tpu_torch.ops import flash_attention as t_fa
from ray_tpu_torch.train.step import (
    default_optimizer,
    init_train_state,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from ray_tpu_torch.weights import params_from_numpy

ACT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: more intra-op threads only contend with the other
    # test workers for the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(n_kv_heads=2, **kw):
    jcfg = dataclasses.replace(J_CONFIGS["tiny"], dtype=jnp.float32,
                               n_kv_heads=n_kv_heads, **kw)
    tcfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                               n_kv_heads=n_kv_heads, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(seed, b=2, s=SEQ, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    mask = np.ones((b, s + 1), np.int32)
    mask[0, -5:] = 0  # a padded tail
    return tokens, mask


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}": v for k in tree for kk, v in _flat(tree[k]).items()}
    return {"": tree}


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("n_kv_heads", [2, 4])
def test_forward_and_loss_match_reference(attention, n_kv_heads):
    """n_kv_heads 2 is a GQA group of 2 (the split backward route under
    flash), 4 is plain MHA (the fused route)."""
    jcfg, tcfg = _cfgs(n_kv_heads, attention=attention)
    jp, tp = _params(jcfg, tcfg)
    tokens, mask = _batch(0)
    jlogits = j_make_forward(jcfg)(jp, jnp.asarray(tokens[:, :-1]))
    logits = make_forward(tcfg)(tp, torch.from_numpy(tokens[:, :-1]))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **ACT_TOL)
    batch = {"tokens": tokens, "mask": mask}
    jloss = j_make_loss_fn(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = make_loss_fn(tcfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **GRAD_TOL)
    if attention == "flash":
        assert t_fa._LAST_IMPL == "plain"


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_grads_match_reference_under_every_remat_policy(attention):
    jcfg, tcfg = _cfgs(2, attention=attention, loss_chunk=8)
    jp, tp = _params(jcfg, tcfg)
    tokens, mask = _batch(1)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    jgrads = _flat(jax.tree.map(np.asarray, jax.grad(j_make_loss_fn(jcfg))(jp, jbatch)))
    tbatch = {"tokens": torch.from_numpy(tokens), "mask": torch.from_numpy(mask)}
    for remat, policy in ((False, "full"), (True, "full"), (True, "flash_min"),
                          (True, "flash_qkv")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        leaves = _flat(tp)
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        make_loss_fn(cfg)(tp, tbatch).backward()
        for name, t in leaves.items():
            np.testing.assert_allclose(_np(t.grad), jgrads[name], **GRAD_TOL,
                                       err_msg=f"{policy} remat={remat} {name}")


def test_unported_options_raise():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_forward(dataclasses.replace(tcfg, remat_policy="dots_no_batch"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_forward(dataclasses.replace(tcfg, attention="ring"))
    # remat off: the policy is not read
    make_forward(dataclasses.replace(tcfg, remat=False, remat_policy="dots"))


def test_lr_schedule_matches_optax():
    ours = default_optimizer(lr=1e-3, warmup=10).lr
    theirs = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10000, 1e-4)
    short = warmup_cosine_decay_schedule(0.0, 2e-3, 5, 20, 2e-4)
    theirs_short = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 5, 20, 2e-4)
    assert ours(0) == 0.0
    for count in range(30):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6, atol=0)
        np.testing.assert_allclose(short(count), float(theirs_short(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_five_step_trajectory_matches_reference(mu_dtype):
    """JAX's sharded step on a one-device mesh with the "dp" rules (as
    __graft_entry__ builds its oracle) against the port's step, from the
    same parameters, over the same five batches: every step's loss and
    pre-clip grad norm agree. The port runs the main path's options
    (flash attention, flash_min remat); JAX runs dense with full remat,
    the same function."""
    jcfg, tcfg = _cfgs(2)
    tcfg = dataclasses.replace(tcfg, attention="flash", remat_policy="flash_min")
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    rules = PRESET_RULES["dp"]
    jopt = j_default_optimizer(lr=1e-2, warmup=2,
                               mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    init_fn, shardings = j_make_sharded_init(jcfg, mesh, rules, jopt)
    jstate = init_fn(jax.random.PRNGKey(0))
    jstep = j_make_train_step(jcfg, mesh, rules, jopt, shardings)
    tp = params_from_numpy(jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu")
    topt = default_optimizer(lr=1e-2, warmup=2,
                             mu_dtype=None if mu_dtype is None else torch.bfloat16)
    tstate = init_train_state(tp, topt)
    tstep = make_train_step(tcfg, topt)
    for i in range(5):
        tokens, mask = _batch(10 + i, b=4)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                    "mask": jnp.asarray(mask)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens),
                                    "mask": torch.from_numpy(mask)})
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(_np(tm["loss"]), float(jm["loss"]), **GRAD_TOL,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(_np(tm["grad_norm"]), float(jm["grad_norm"]),
                                   **GRAD_TOL, err_msg=f"grad_norm, step {i}")
    mu = _flat(tstate.opt_state["mu"])
    assert all(m.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
               for m in mu.values())
