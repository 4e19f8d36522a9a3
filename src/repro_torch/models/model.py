"""The decoder-only LM: schema, forward (train / prefill / decode), caches.
Port of ``repro/models/model.py`` for the families ``dense``, ``hybrid``
and ``ssm`` (layer types attn, rec and rwkv).

Parameters are plain dicts of tensors: {"embed": {"tok"},
"layers": [one dict per decoder layer], "final_norm"[, "head"]}.  Layers
run as a Python loop in ``cfg.layer_types()`` order; the JAX package
scans stacked stages instead, and ``core/convert.lm_params_from_jax``
unstacks them.  In training (``ctx.mode == "train"`` with grad enabled)
and with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward pass, as JAX ``jax.checkpoint``s each scan
body.  Experts, an encoder (with learned positions) and a patch
prefix raise ``NotImplementedError`` (ROADMAP A.12).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.attention import ModelCtx
from repro_torch.models.common import (DTYPES, ParamSpec, apply_norm,
                                       init_from_schema, norm_schema)


def check_slice(cfg) -> None:
    """Raise for configurations outside the port's LM slice: experts, an
    encoder (whisper, the one config with learned positions) and a patch
    prefix."""
    outside = {"n_experts": cfg.n_experts, "enc_layers": cfg.enc_layers,
               "n_patches": cfg.n_patches, "pos": cfg.pos == "learned"}
    for name, value in outside.items():
        if value:
            raise NotImplementedError(
                f"{cfg.name}: {name} = {getattr(cfg, name)!r} "
                f"({cfg.family}) is not ported to repro_torch yet: it waits "
                f"for ROADMAP A.12")


# ------------------------------------------------------------------- schema
def model_schema(cfg) -> dict:
    check_slice(cfg)
    D, V = cfg.d_model, cfg.vocab
    pd = cfg.param_dtype
    s = {"embed": {"tok": ParamSpec((V, D), ("vocab", "embed_r"), dtype=pd,
                                    fan_in_dims=(1,))}}
    s["layers"] = [blocks.layer_schema(cfg, t) for t in cfg.layer_types()]
    s["final_norm"] = norm_schema(cfg)
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((V, D), ("vocab", "embed_r"), dtype=pd,
                              fan_in_dims=(1,))
    return s


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random parameters drawn on ``device`` from a generator seeded with
    ``seed``, by the JAX package's init rules."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_from_schema(model_schema(cfg), gen, device)


# ------------------------------------------------------------------- caches
def init_cache(cfg, batch: int, s_cache: int, tp: int = 1,
               device="cuda") -> list:
    """Decode cache: one dict per decoder layer."""
    check_slice(cfg)
    return [blocks.layer_cache(cfg, t, batch, s_cache, tp, device)
            for t in cfg.layer_types()]


# ------------------------------------------------------------------ forward
def _embed(params, cfg, tokens):
    return params["embed"]["tok"][tokens].to(DTYPES[cfg.param_dtype])


def logits_fn(params, cfg, x):
    """Logits in the parameter dtype, as the JAX package keeps them."""
    x = apply_norm(params["final_norm"], x, cfg)
    table = params["head"] if "head" in params else params["embed"]["tok"]
    return x @ table.T


def _layer_train(p, x, ltype, cfg, ctx):
    return blocks.apply_layer(p, x, ltype, cfg, ctx)[0]


def forward(params, cfg, ctx: ModelCtx, tokens, *, cache=None,
            last: bool = False):
    """train/prefill: tokens [B, S]; decode: tokens [B, 1] with ``cache``
    and ``ctx.pos``.  ``last`` applies the head to the last position only
    (what prefill returns: the head is row-wise).  Returns (logits,
    new_cache)."""
    check_slice(cfg)
    x = _embed(params, cfg, tokens)
    new_cache = None if cache is None else []
    remat = (ctx.mode == "train" and cfg.remat and cache is None
             and torch.is_grad_enabled())
    for i, t in enumerate(cfg.layer_types()):
        if remat:
            x = checkpoint(_layer_train, params["layers"][i], x, t, cfg, ctx,
                           use_reentrant=False)
            continue
        x, c = blocks.apply_layer(params["layers"][i], x, t, cfg, ctx,
                                  cache=None if cache is None else cache[i])
        if new_cache is not None:
            new_cache.append(c)
    if last:
        x = x[:, -1:]
    return logits_fn(params, cfg, x), new_cache
