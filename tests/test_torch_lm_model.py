"""The port's decoder (src/repro_torch/models/) against the JAX package.

For the smoke configurations of recurrentgemma-9b (hybrid: RG-LRU and
local attention), rwkv6-3b (ssm), qwen3-32b (dense, qk-norm) and
starcoder2-3b (dense, layernorm, gelu, QKV bias), float32, with one JAX
``init_params`` draw carried across by ``convert.lm_params_from_jax``:

- the full forward's logits against JAX ``model.forward``;
- prefill plus 8 greedy decode steps against JAX ``build_prefill_step`` /
  ``build_decode_step``, caches included, on a 40-token prompt (longer
  than the smoke window of 32, so the rolling cache wraps);
- the port's prefill and decode against its own full forward.

Tolerances (tests/lm_harness.py): logits rtol 1e-4 with atol 1e-4 x
max|logit|; float32 cache leaves rtol 1e-4 with atol 1e-5 x max|leaf|;
bfloat16 cache leaves within 1 bf16 ulp (atol 1e-5 x max|leaf| near 0);
greedy tokens identical, with the top-2 logit gap of every step printed.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from lm_harness import (assert_bf16_close, assert_scaled_close, jax_generate,
                        jax_init, top2_gaps)
from repro import configs as jconfigs
from repro.models import model as jm
from repro.models.attention import ModelCtx as JaxCtx
from repro_torch import configs
from repro_torch.core.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.models import model as pm
from repro_torch.models import steps
from repro_torch.models.attention import ModelCtx
from repro_torch.models.common import flatten

ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "qwen3-32b", "starcoder2-3b")
B, PROMPT, GEN = 2, 40, 9      # prefill + 8 decode steps


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    """(port cfg, port params, JAX cfg, JAX params, prompt)."""
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, npp = jax_init(jcfg, seed=1)
    params = lm_params_from_jax(cfg, npp)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    return cfg, params, jcfg, jp, prompt


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str):
    _, _, jcfg, jp, prompt = _setup(arch)
    return jax_generate(jcfg, jp, prompt, GEN)


def _port_run(arch: str):
    """The port's prefill and decode on the JAX run's greedy tokens:
    (logits per step, final cache)."""
    cfg, params, _, _, prompt = _setup(arch)
    want_tokens, _, _ = _jax_run(arch)
    prefill = steps.build_prefill_step(cfg, PROMPT + GEN)
    decode = steps.build_decode_step(cfg)
    cache, logits = prefill(params, {"tokens": torch.from_numpy(
        prompt).long()})
    logs = [logits]
    for i in range(GEN - 1):
        tok = torch.from_numpy(want_tokens[:, i:i + 1]).long()
        logits, cache = decode(params, cache, tok, PROMPT + i)
        logs.append(logits)
    return logs, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    cfg, params, jcfg, jp, prompt = _setup(arch)
    want, _, _, _ = jax.jit(lambda p, t: jm.forward(
        p, jcfg, JaxCtx(mode="train"), t))(jp, prompt)
    got, cache = pm.forward(params, cfg, ModelCtx(mode="train"),
                            torch.from_numpy(prompt).long())
    assert cache is None
    assert got.shape == (B, PROMPT, cfg.vocab)
    assert bool(torch.isfinite(got).all())
    assert_scaled_close(got, np.asarray(want), 1e-4, 1e-4, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg = _setup(arch)[0]
    want_tokens, want_logits, want_cache = _jax_run(arch)
    logs, cache = _port_run(arch)
    gaps = []
    for i, (got, want) in enumerate(zip(logs, want_logits)):
        assert_scaled_close(got, want, 1e-4, 1e-4, f"{arch} step {i}")
        assert np.array_equal(got.argmax(-1).numpy(), want_tokens[:, i]), (
            f"{arch} step {i}: greedy token differs; top-2 gaps "
            f"{top2_gaps(want)}")
        gaps.append(top2_gaps(want).min())
    print(f"{arch}: smallest top-2 logit gap per step {np.round(gaps, 6)}")
    want_c = flatten(lm_cache_from_jax(cfg, want_cache))
    got_c = flatten(cache)
    assert [p for p, _ in got_c] == [p for p, _ in want_c]
    for (path, g), (_, w) in zip(got_c, want_c):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        scale = max(float(w.float().abs().max()), 1e-30)
        if g.dtype == torch.bfloat16:
            assert_bf16_close(g, w, ulps=1, atol=1e-5 * scale,
                              what=f"{arch} cache {path}")
        else:
            assert_scaled_close(g, w, 1e-4, 1e-5, f"{arch} cache {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_own_forward(arch):
    """The cache path reproduces the full forward at every generated
    position.  The caches hold bfloat16 (K/V, conv and token-shift tails)
    where the forward keeps float32, so decode logits agree to the
    bfloat16 rounding of those tails: rtol 2e-3 with atol 2e-3 x
    max|logit|, half of bfloat16's relative step 2**-8 (measured: up to
    5.2e-4 on qwen3's smoke config; a wrong slot or tail is off by the
    logits' whole scale).  The prefill's own logits use no cache: 1e-4."""
    cfg, params, _, _, prompt = _setup(arch)
    want_tokens, _, _ = _jax_run(arch)
    logs, _ = _port_run(arch)
    seq = np.concatenate([prompt, want_tokens[:, :GEN - 1]], axis=1)
    full, _ = pm.forward(params, cfg, ModelCtx(mode="train"),
                         torch.from_numpy(seq).long())
    for i, got in enumerate(logs):
        want = full[:, PROMPT - 1 + i]
        err = float((got - want).abs().max() / want.abs().max())
        print(f"{arch} position {PROMPT - 1 + i}: max error / max|logit| "
              f"{err:.3g}")
        frac = 1e-4 if i == 0 else 2e-3
        assert_scaled_close(got, want, frac, frac,
                            f"{arch} position {PROMPT - 1 + i}")

