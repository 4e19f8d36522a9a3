"""Shared checks of the repro_torch training parity tests (not a test
module): the port's training step against the JAX package's on one
smoke configuration, float32, the same JAX ``init_params`` draw carried
across by ``convert.lm_params_from_jax`` (the AdamW state by
``convert.adamw_state_from_jax``) and the same numpy tokens into both.

- ``check_loss_and_grads``: the loss and every parameter's gradient
  against ``jax.value_and_grad`` of JAX ``steps.loss_fn``;
- ``check_adamw_step``: one step of the port's train step against JAX
  ``build_train_step`` on a 1 x 1 host mesh (n_micro 1 or 2): loss,
  gnorm and lr, m and v, and the parameters; and the port's parameters
  against JAX ``AdamW.update`` applied to the port's own gradients and
  the same state;
- ``check_remat``: remat on gives the same bits as remat off.

Tolerances (tests/lm_harness.py's LM rule): loss rtol 1e-5; gradients,
m and v rtol 1e-4 with an atol of 1e-4 times the reference leaf's
largest magnitude (a layer stack compounds float32 sums taken in another
order; values near 0 have no relative precision to hold); gnorm rtol
1e-4; the parameters against ``AdamW.update`` on the port's gradients
rtol 1e-5 / atol 1e-7 (the same float32 update).  The parameters against
JAX's step are held to the LM rule where the gradient (JAX's m after the
step, 0.1 g) is above 1e-2 of its leaf's largest: AdamW's first update is
lr g / (|g| + eps), so where |g| is near eps (1e-8) a gradient difference
of 1e-10, well inside the gradient's tolerance, moves the parameter by
up to lr times the gradient's relative difference (measured: 4.6e-7 on
qwen2-7b's bk, whose max is 1e-3).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lm_harness import (assert_close, assert_scaled_close, jax_init,
                        params_to_jax, to_numpy)
from repro import configs as jconfigs
from repro.models import steps as js
from repro.models.attention import ModelCtx as JaxCtx
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.core.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models import steps
from repro_torch.models.common import flatten
from repro_torch.optim import AdamW

B, S = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def _init(arch: str):
    return jax_init(jconfigs.get_smoke(arch), seed=3)


def setup(arch: str, n_micro: int = 1):
    """(JAX cfg, port cfg, JAX params, the params as numpy, tokens)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_micro=n_micro)
    cfg = dataclasses.replace(configs.get_smoke(arch), n_micro=n_micro)
    jp, npp = _init(arch)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return jcfg, cfg, jp, npp, tokens


def batch(tokens) -> dict:
    return {"tokens": torch.from_numpy(tokens).long()}


def leaves(tree) -> dict:
    return {path: t for path, t in flatten(tree)}


def compare_trees(port, want, what):
    want, got = leaves(want), leaves(port)
    assert set(got) == set(want), what
    for path, t in got.items():
        assert_scaled_close(t.detach(), want[path], 1e-4, 1e-4,
                            f"{what} {path}")


def check_loss_and_grads(arch: str):
    jcfg, cfg, jp, npp, tokens = setup(arch)
    ctx = JaxCtx(mode="train")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: js.loss_fn(p, jcfg, ctx, {"tokens": t},
                                lambda x, a: x)))(jp, jnp.asarray(tokens))
    got_loss, got = steps.value_and_grad(lm_params_from_jax(cfg, npp), cfg,
                                         batch(tokens))
    assert_close(got_loss, np.asarray(loss), 1e-5, 0.0, "loss")
    compare_trees(got, lm_params_from_jax(cfg, to_numpy(grads)), "grad")


def check_adamw_step(arch: str, n_micro: int):
    jcfg, cfg, jp, npp, tokens = setup(arch, n_micro)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jopt = JAdamW.from_config(jcfg, **OPT)
    jstate = jopt.init(jp)
    jp2, jstate2, jm = jax.jit(js.build_train_step(jcfg, mesh, jopt))(
        jp, jstate, {"tokens": jnp.asarray(tokens)}, jnp.int32(0))

    # The port's own gradients through JAX's optimizer.
    _, grads = steps.value_and_grad(lm_params_from_jax(cfg, npp), cfg,
                                    batch(tokens))
    jg = jax.tree.map(jnp.asarray, params_to_jax(cfg, grads))
    jp3, _, _ = jax.jit(jopt.update)(jg, jstate, jp, jnp.int32(0))

    params = lm_params_from_jax(cfg, npp)
    state = adamw_state_from_jax(cfg, to_numpy(jstate))
    ts = steps.build_train_step(cfg, AdamW.from_config(cfg, **OPT))
    params, state, m = ts(params, state, batch(tokens), 0)
    assert_close(m["loss"], np.asarray(jm["loss"]), 1e-5, 0.0, "loss")
    assert_close(m["gnorm"], np.asarray(jm["gnorm"]), 1e-4, 0.0, "gnorm")
    assert_close(m["lr"], np.asarray(jm["lr"]), 0.0, 0.0, "lr")
    want_state = adamw_state_from_jax(cfg, to_numpy(jstate2))
    for k in ("m", "v"):
        compare_trees(state[k], want_state[k], k)
    want = leaves(lm_params_from_jax(cfg, to_numpy(jp2)))
    exact = leaves(lm_params_from_jax(cfg, to_numpy(jp3)))
    moment = leaves(want_state["m"])
    for path, t in leaves(params).items():
        t = t.detach()
        assert_close(t, exact[path], 1e-5, 1e-7, f"param {path} (update)")
        g = moment[path].abs()
        sure = g > 1e-2 * float(g.max())
        assert_scaled_close(t[sure], want[path][sure], 1e-4, 1e-4,
                            f"param {path}")


def check_remat(arch: str):
    _, cfg, _, npp, tokens = setup(arch)
    assert cfg.remat
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = steps.value_and_grad(lm_params_from_jax(c, npp), c,
                                          batch(tokens))
    assert torch.equal(out[True][0], out[False][0])
    on, off = leaves(out[True][1]), leaves(out[False][1])
    for path in on:
        assert torch.equal(on[path], off[path]), path
