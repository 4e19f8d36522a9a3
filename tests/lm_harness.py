"""Shared helpers of the repro_torch language-model parity tests (not a
test module): tolerance checks, and the JAX package's serving steps run on
numpy inputs.

Tolerances, and why:
- float32 outputs: rtol 1e-5 / atol 1e-5 for one kernel (sums in another
  order than XLA's), and for a whole model rtol 1e-4 with an atol of 1e-4
  (logits) or 1e-5 (float32 cache leaves) times the largest magnitude:
  a layer stack compounds those orders, and values near 0 have no
  relative precision to hold.
- bfloat16 outputs: at most ``ulps`` units in the last place of bfloat16
  apart (2 for one kernel, 1 for a cache leaf), since both sides round
  one float32 value that agrees to float32 precision; values within
  ``atol`` of each other pass too, because near 0 one float32 rounding
  step spans many bfloat16 units.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.mesh import make_host_mesh
from repro.models import model as jm
from repro.models import steps as js


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two bfloat16 tensors in units in the last place."""
    def ordered(x):
        i = x.to(torch.bfloat16).contiguous().view(torch.int16).to(
            torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def assert_bf16_close(a, b, ulps: int, atol: float, what=""):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    near = (a.float() - b.float()).abs() <= atol
    bad = (bf16_ulps(a, b) > ulps) & ~near
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {bad.numel()} values more than "
        f"{ulps} bf16 ulps apart (max {int(bf16_ulps(a, b).max())})")


def _f32(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_close(a, b, rtol: float, atol: float, what=""):
    torch.testing.assert_close(_f32(a), _f32(b), rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def assert_scaled_close(a, b, rtol: float, frac: float, what=""):
    """rtol, with an atol of ``frac`` times the reference's largest
    magnitude."""
    b = _f32(b)
    scale = float(b.abs().max()) if b.numel() else 0.0
    assert_close(a, b, rtol, frac * max(scale, 1e-30), what)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(jcfg, seed: int = 0):
    """(JAX params, the same params as numpy arrays)."""
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, to_numpy(jp)


def jax_generate(jcfg, jparams, tokens: np.ndarray, gen: int):
    """The JAX serving path on ``tokens``: prefill, then ``gen - 1``
    greedy decode steps.  Returns (greedy tokens [B, gen], [logits per
    step as numpy], final cache as numpy)."""
    mesh = make_host_mesh()
    S = tokens.shape[1]
    prefill = jax.jit(js.build_prefill_step(jcfg, mesh, S + gen))
    decode = jax.jit(js.build_decode_step(jcfg, mesh))
    cache, logits = prefill(jparams, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)})
    logs = [np.asarray(logits)]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(jparams, cache, tok, jnp.int32(S + i))
        logs.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1), logs, to_numpy(cache)


def params_to_jax(cfg, params) -> dict:
    """The JAX ``init_params`` tree (stacked stages, numpy) holding the
    port's float32 parameters: the inverse of
    ``convert.lm_params_from_jax``."""
    def arr(t):
        return t.detach().cpu().numpy()

    def tmap(fn, *trees):
        if isinstance(trees[0], dict):
            return {k: tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
        return fn(*trees)

    out = {k: tmap(arr, params[k]) for k in ("embed", "final_norm", "head")
           if k in params}
    stages, offset = [], 0
    for pattern, n in cfg.stage_split():
        stage = {}
        for i in range(len(pattern)):
            layers = [params["layers"][offset + j * len(pattern) + i]
                      for j in range(n)]
            stage[str(i)] = tmap(lambda *ts: np.stack([arr(t) for t in ts]),
                                 *layers)
        stages.append(stage)
        offset += n * len(pattern)
    out["stages"] = stages
    return out


def top2_gaps(logits: np.ndarray) -> np.ndarray:
    """Per row, the gap between the largest and second-largest logit."""
    top = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]
