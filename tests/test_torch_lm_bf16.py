"""The served bfloat16 models against the JAX package.

The smoke configurations of recurrentgemma-9b, rwkv6-3b, qwen3-32b and
starcoder2-3b with ``param_dtype="bfloat16"`` on both sides, one JAX
``init_params`` draw (seed 1) carried across by
``convert.lm_params_from_jax``, B 2, a 40-token prompt:

- the full forward's logits: the port-vs-JAX relative L2 distance must be
  at most twice JAX's own distance between its bfloat16 model and the
  float32 model of the same (upcast) weights;
- prefill plus 8 greedy decode steps, each side generating its own
  tokens: the greedy tokens must agree.

Why a relative bound and not the float32 tests' 1e-4: in bfloat16 the
two packages round activations at different places.  jax's bfloat16
``sigmoid``, ``silu``, ``gelu`` (tanh) and ``softplus`` differ from
"compute in float32, round once" in 20-40% of elements (relative
1.9-3.6e-3), while torch's bfloat16 versions equal it (ROADMAP C.1).  The
reference's own rounding error is the scale of its bfloat16-vs-float32
distance, so a port that rounds once per op should sit no farther from
it than about that distance; twice it leaves room for the two rounding
errors adding.  XLA's internal rounding is not emulated.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_harness import jax_generate, jax_init
from repro import configs as jconfigs
from repro.models import model as jm
from repro.models.attention import ModelCtx as JaxCtx
from repro_torch import configs
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.models import model as pm
from repro_torch.models import steps
from repro_torch.models.attention import ModelCtx

ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "qwen3-32b", "starcoder2-3b")
B, PROMPT, GEN = 2, 40, 9      # prefill + 8 decode steps


def rel_l2(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    """(port cfg, port params, JAX bf16 cfg, JAX bf16 params, prompt)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype="bfloat16")
    jp, npp = jax_init(jcfg, seed=1)
    params = lm_params_from_jax(cfg, npp)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    return cfg, params, jcfg, jp, prompt


def _jax_forward(jcfg, jp, prompt) -> np.ndarray:
    logits = jax.jit(lambda p, t: jm.forward(
        p, jcfg, JaxCtx(mode="train"), t))(jp, prompt)[0]
    return np.asarray(logits, dtype=np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_the_references_own_rounding(arch):
    cfg, params, jcfg, jp, prompt = _setup(arch)
    want = _jax_forward(jcfg, jp, prompt)
    f32 = dataclasses.replace(jcfg, param_dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
    own = rel_l2(want, _jax_forward(f32, jp32, prompt))
    got, _ = pm.forward(params, cfg, ModelCtx(mode="train"),
                        torch.from_numpy(prompt).long())
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    dist = rel_l2(got.float().numpy(), want)
    print(f"{arch}: port-vs-JAX {dist:.3g}, JAX bf16-vs-f32 {own:.3g}")
    assert 0 < own and dist <= 2 * own, (arch, dist, own)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_greedy_tokens_match_jax(arch):
    cfg, params, jcfg, jp, prompt = _setup(arch)
    want, _, _ = jax_generate(jcfg, jp, prompt, GEN)
    prefill = steps.build_prefill_step(cfg, PROMPT + GEN)
    decode = steps.build_decode_step(cfg)
    cache, logits = prefill(params, {"tokens": torch.from_numpy(
        prompt).long()})
    tok = logits.argmax(-1)[:, None]
    got = [tok]
    for i in range(GEN - 1):
        logits, cache = decode(params, cache, tok, PROMPT + i)
        tok = logits.argmax(-1)[:, None]
        got.append(tok)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want,
                                  err_msg=arch)
