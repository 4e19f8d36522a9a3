"""Serving step factories: prefill and decode on one card.

Port of the serving half of ``repro/models/steps.py`` with ``tp = 1`` and
``n_groups = 1``: the JAX steps on a one-device host mesh, whose sharding
constraints are the identity.  ``plain`` runs the kernels' plain versions
even on the card (the reference route).  Training (``build_train_step``,
``xent_loss``) waits for ROADMAP A.12.
"""
from __future__ import annotations

from repro_torch.models import model as model_mod
from repro_torch.models.attention import ModelCtx


def build_prefill_step(cfg, s_cache: int, plain: bool = False):
    """prefill_step(params, batch) -> (cache, last-position logits
    [B, V]); the cache holds ``s_cache`` positions."""
    ctx = ModelCtx(mode="prefill", plain=plain)

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = model_mod.init_cache(cfg, tokens.shape[0], s_cache,
                                     device=tokens.device)
        logits, cache = model_mod.forward(params, cfg, ctx, tokens,
                                          cache=cache, last=True)
        return cache, logits[:, -1]

    return prefill_step


def build_decode_step(cfg, plain: bool = False):
    """decode_step(params, cache, tokens [B, 1], pos) -> (logits [B, V],
    cache); attention caches are updated in place."""

    def decode_step(params, cache, tokens, pos: int):
        ctx = ModelCtx(mode="decode", pos=int(pos), plain=plain)
        logits, cache = model_mod.forward(params, cfg, ctx, tokens,
                                          cache=cache)
        return logits[:, -1], cache

    return decode_step
