"""Shared model machinery: parameter schemas, init, norms, RoPE.

Parameters are declared as a *schema*: nested dicts and lists whose leaves
are ``ParamSpec`` (shape, dtype, logical axis names, init rule), as in the
JAX package.  ``init_from_schema`` materializes one on a device from an
explicit ``torch.Generator``, leaf by leaf in ``flatten`` order (dict keys
sorted, list items in order).  It draws its own numbers: to hold the port
against the JAX package, carry the JAX draw across
(``core/convert.lm_params_from_jax``).

The norms and RoPE keep the JAX package's casts: statistics in float32,
the result cast back to the input's dtype before the scale.  A float64
model (the plain route's reference in ``chip_smoke.py``'s training gate)
keeps float64 throughout: ``widen`` is float32 or wider.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is when float64."""
    return t if t.dtype == torch.float64 else t.float()


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axis names, len == len(shape)
    init: str = "normal"        # normal | zeros | ones | decay_bias |
                                # lambda_lru
    dtype: str = "bfloat16"
    fan_in_dims: tuple = ()     # dims whose product scales the normal init
    zero_rows: Optional[tuple] = None  # (dim, start): zero slices >= start
                                       # (padded attention heads)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def flatten(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k],
                                                           prefix + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamSpec):
        return [kv for i, t in enumerate(tree)
                for kv in flatten(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dtype = DTYPES[spec.dtype]
    shape = tuple(spec.shape)
    if spec.init == "zeros":
        x = torch.zeros(shape, dtype=dtype, device=device)
    elif spec.init == "ones":
        x = torch.ones(shape, dtype=dtype, device=device)
    elif spec.init == "decay_bias":
        # RWKV-6 decay bias: channel half-lives spread across the spectrum
        x = torch.linspace(-6.0, 1.0, math.prod(shape), device=device
                           ).reshape(shape).to(dtype)
    elif spec.init == "lambda_lru":
        # RG-LRU Lambda: a = exp(-8 softplus(lam) * gate) ~ U[0.9, 0.999]
        u = torch.rand(shape, generator=gen, device=device) * 0.099 + 0.9
        x = torch.log(torch.expm1(-torch.log(u) / 8.0)).to(dtype)
    else:
        dims = spec.fan_in_dims or tuple(range(max(len(shape) - 1, 0)))
        fan_in = math.prod(shape[i] for i in dims)
        std = min(0.02, (1.0 / max(fan_in, 1)) ** 0.5)
        x = (torch.randn(shape, generator=gen, device=device) * std
             ).to(dtype)
    if spec.zero_rows is not None:
        dim, start = spec.zero_rows
        x.narrow(dim, start, shape[dim] - start).zero_()
    return x


def init_from_schema(schema, gen: torch.Generator, device) -> dict:
    """Real tensors for every ``ParamSpec`` of ``schema`` on ``device``;
    ``gen`` must live on that device."""
    device = torch.device(device)
    return tree_map(lambda s: _init_leaf(s, gen, device), schema)


# --------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps):
    xf = widen(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * (1.0 + scale.to(x.dtype))


def layernorm(x, scale, bias, eps):
    xf = widen(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def norm_schema(cfg, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("none",), "ones", "float32"),
                "bias": ParamSpec((d,), ("none",), "zeros", "float32")}
    return {"scale": ParamSpec((d,), ("none",), "zeros", "float32")}


def apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------- RoPE
def rope(x, positions, theta: float):
    """x: [..., S, n, d_head]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    ft = torch.promote_types(x.dtype, torch.float32)
    freq = theta ** (-torch.arange(0, half, dtype=ft, device=x.device)
                     / half)
    ang = positions[..., None].to(ft) * freq               # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = widen(x[..., :half]), widen(x[..., half:])
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
