"""AdamW (port of ``repro/optim/adamw.py``): an optional float32 master
copy, a configurable moment dtype, global-norm clipping and a
linear-warmup cosine schedule.

Parameters, gradients and state are trees of dicts and lists of tensors
(``models/common.flatten`` order).  The arithmetic is the JAX package's,
step for step: gradients to float32, ``gnorm`` over every leaf, the clip
scale ``min(1, clip_norm / max(gnorm, 1e-12))``, bias-corrected moments,
``new = base - lr * (upd + weight_decay * base)`` where ``base`` is the
master copy for a parameter that is not float32 (``master_f32``) and the
parameter otherwise.  Not ``torch.optim.AdamW``, whose decay order and
rounding differ.  Unlike the JAX optimizer, ``update`` writes the new
parameters and state into the tensors it was given (in place: one copy of
the model's state on the card, not two) and returns them.  The schedule
and the bias corrections are float32 scalars on the host, as JAX's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import DTYPES, flatten, tree_map


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    master_f32: bool = True

    @staticmethod
    def from_config(cfg, **kw) -> "AdamW":
        return AdamW(moment_dtype=cfg.adam_moment_dtype,
                     master_f32=cfg.adam_master_f32, **kw)

    # ------------------------------------------------------------- schedule
    def lr(self, step) -> torch.Tensor:
        """The learning rate at ``step``: a float32 0-d tensor on the
        host."""
        step = _f32(float(step))
        warm = step / max(self.warmup_steps, 1)
        t = torch.clamp((step - self.warmup_steps)
                        / max(self.total_steps - self.warmup_steps, 1),
                        0.0, 1.0)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return self.peak_lr * torch.where(step < self.warmup_steps, warm,
                                          cos)

    # ---------------------------------------------------------------- state
    def _needs_master(self, p: torch.Tensor) -> bool:
        return self.master_f32 and p.dtype != torch.float32

    def init(self, params) -> dict:
        mdt = DTYPES[self.moment_dtype]
        state = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                               params),
                 "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                               params)}
        if self.master_f32:
            # float32 parameters get a 0-d placeholder, as in JAX.
            state["master"] = tree_map(
                lambda p: (p.detach().float().clone()
                           if self._needs_master(p)
                           else torch.zeros((), dtype=torch.float32,
                                            device=p.device)), params)
        return state

    # --------------------------------------------------------------- update
    @torch.no_grad()
    def update(self, grads, state, params, step):
        """One step: ``params`` and ``state`` updated in place; returns
        (params, state, {"gnorm", "lr"}), gnorm a float32 0-d tensor on the
        parameters' device."""
        ps = [p for _, p in flatten(params)]
        gs = [g for _, g in flatten(grads)]
        ms = [m for _, m in flatten(state["m"])]
        vs = [v for _, v in flatten(state["v"])]
        mas = ([t for _, t in flatten(state["master"])]
               if "master" in state else [None] * len(ps))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in gs))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = self.lr(step)
        stepf = _f32(float(step)) + 1.0
        c1 = float(1.0 - self.b1 ** stepf)
        c2 = float(1.0 - self.b2 ** stepf)
        lr_f, wd = float(lr), self.weight_decay
        for p, g, m, v, ma in zip(ps, gs, ms, vs, mas):
            g = g.float() * scale
            m_new = self.b1 * m.float() + (1 - self.b1) * g
            v_new = self.b2 * v.float() + (1 - self.b2) * g * g
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            use_master = (ma is not None and ma.dim() == p.dim()
                          and self._needs_master(p))
            base = ma if use_master else p.float()
            new = base - lr_f * (upd + wd * base)
            p.copy_(new)
            m.copy_(m_new)
            v.copy_(v_new)
            if use_master:
                ma.copy_(new)
        return params, state, {"gnorm": gnorm, "lr": lr}
