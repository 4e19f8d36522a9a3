"""Step factories: train, prefill and decode on one card.

Port of ``repro/models/steps.py`` with ``tp = 1`` and ``n_groups = 1``:
the JAX steps on a one-device host mesh, whose sharding constraints are
the identity.  ``plain`` runs the kernels' plain versions even on the
card (the reference route, differentiated by autograd through plain
torch ops); otherwise attention goes through ``flash_attention`` and the
recurrences through ``rglru`` and ``rwkv6``, each an autograd Function
whose forward and backward are kernels on the card, so all three
families train there; on the CPU the Functions run the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.attention import ModelCtx
from repro_torch.models.common import DTYPES, flatten, tree_map, widen


# -------------------------------------------------------------------- loss
def xent_loss(logits, labels, mask):
    """Mean next-token cross-entropy over masked positions, in float32
    (the max is held constant, as JAX's ``stop_gradient``)."""
    lf = widen(logits)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    lab = torch.gather(lf, -1, labels[..., None])[..., 0]
    per_tok = (lse - lab) * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg, ctx: ModelCtx, batch):
    """Next-token loss of ``batch["tokens"]`` [B, S + 1]."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _ = model_mod.forward(params, cfg, ctx, inp)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    return xent_loss(logits, labels, mask)


# ------------------------------------------------------------------- train
def value_and_grad(params, cfg, batch, plain: bool = False):
    """(loss, grads) of ``batch``: with ``cfg.n_micro`` > 1 the batch is
    split into n_micro microbatches along B, their gradients summed in
    ``cfg.grad_dtype`` and divided by n_micro (and the loss averaged), as
    the JAX step's scan; grads are a tree like ``params``."""
    ctx = ModelCtx(mode="train", plain=plain)
    leaves = [p for _, p in flatten(params)]
    for p in leaves:
        p.requires_grad_(True)
    nm = cfg.n_micro
    if nm == 1:
        loss = loss_fn(params, cfg, ctx, batch)
        gs = _grad(loss, leaves)
        loss = loss.detach()
    else:
        gdt = DTYPES[cfg.grad_dtype]
        B = batch["tokens"].shape[0]
        gs = [torch.zeros_like(p, dtype=gdt) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for i in range(nm):
            mb = {k: v.reshape((nm, B // nm) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            lo = loss_fn(params, cfg, ctx, mb)
            for acc, g in zip(gs, _grad(lo, leaves)):
                acc.add_(g.to(gdt))
            loss = loss + lo.detach()
        for g in gs:
            g.div_(nm)
        loss = loss / nm
    it = iter(gs)
    return loss, tree_map(lambda _: next(it), _sorted(params))


def _grad(loss, leaves) -> list:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    reach."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def _sorted(tree):
    """``tree`` with dict keys in ``flatten`` order (sorted)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    return tree


def build_train_step(cfg, optimizer, plain: bool = False):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "gnorm", "lr"}); the parameters and the optimizer state are
    updated in place (``AdamW.update``)."""

    def train_step(params, opt_state, batch, step):
        loss, grads = value_and_grad(params, cfg, batch, plain=plain)
        params, opt_state, om = optimizer.update(grads, opt_state, params,
                                                 step)
        return params, opt_state, {"loss": loss, **om}

    return train_step


# ----------------------------------------------------------------- serving
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
