"""Decoder layer assembly: per-type schemas, caches and apply functions.
Port of ``repro/models/blocks.py`` for the decoder families of the slice.

Layer types (config.pattern entries):
  attn  pre-norm GQA attention + dense MLP
  rec   pre-norm RG-LRU recurrent block + MLP (recurrentgemma)
  rwkv  RWKV-6 time mix + channel mix

The MoE FFN and the cross-attention sub-block raise
``NotImplementedError`` (ROADMAP A.12).
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.attention import ModelCtx, raise_cross
from repro_torch.models.common import ParamSpec, apply_norm, norm_schema


def raise_moe():
    raise NotImplementedError(
        "mixture-of-experts layers (n_experts > 0) are not ported to "
        "repro_torch yet: they wait for ROADMAP A.12")


# ---------------------------------------------------------------------- MLP
def mlp_schema(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    s = {"w_in": ParamSpec((D, F_), ("embed", "mlp"), dtype=pd,
                           fan_in_dims=(0,)),
         "w_out": ParamSpec((F_, D), ("mlp", "embed"), dtype=pd,
                            fan_in_dims=(0,))}
    if cfg.mlp == "swiglu":
        s["w_gate"] = ParamSpec((D, F_), ("embed", "mlp"), dtype=pd,
                                fan_in_dims=(0,))
    else:
        s["b_in"] = ParamSpec((F_,), ("mlp",), "zeros", pd)
        s["b_out"] = ParamSpec((D,), ("none",), "zeros", pd)
    return s


def mlp_apply(p, x, cfg):
    h = x @ p["w_in"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h + p["b_in"], approximate="tanh")
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# -------------------------------------------------------------------- layer
def layer_schema(cfg, ltype: str, cross: bool = False) -> dict:
    if cross:
        raise_cross()
    if ltype == "attn":
        if cfg.n_experts:
            raise_moe()
        return {"norm1": norm_schema(cfg),
                "attn": attn_mod.attn_schema(cfg),
                "norm2": norm_schema(cfg),
                "ffn": mlp_schema(cfg)}
    if ltype == "rec":
        return {"norm1": norm_schema(cfg),
                "rec": rec_mod.rec_schema(cfg),
                "norm2": norm_schema(cfg),
                "ffn": mlp_schema(cfg)}
    if ltype == "rwkv":
        return {"norm1": norm_schema(cfg),
                "time": rec_mod.rwkv_schema(cfg),
                "norm2": norm_schema(cfg)}
    raise ValueError(f"unknown layer type {ltype}")


def layer_cache(cfg, ltype: str, batch: int, s_cache: int, tp: int,
                device, enc_len: int = 0):
    """Zero cache for one layer."""
    if enc_len:
        raise_cross()
    if ltype == "attn":
        s_c = min(s_cache, cfg.window) if cfg.window else s_cache
        return {"self": attn_mod.cache_schema(cfg, batch, s_c, tp, device)}
    if ltype == "rec":
        return rec_mod.rec_cache(cfg, batch, device)
    if ltype == "rwkv":
        return rec_mod.rwkv_cache(cfg, batch, device)
    raise ValueError(ltype)


def apply_layer(p, x, ltype: str, cfg, ctx: ModelCtx, *, cache=None,
                causal: bool = True):
    """One layer.  Returns (x, new_cache)."""
    if ltype == "attn":
        h = apply_norm(p["norm1"], x, cfg)
        a, self_cache = attn_mod.attention(
            p["attn"], h, cfg, ctx, causal=causal, window=cfg.window,
            use_rope=cfg.pos == "rope",
            cache=None if cache is None else cache["self"], pos=ctx.pos)
        x = x + a
        new_cache = None if cache is None else {"self": self_cache}
        h = apply_norm(p["norm2"], x, cfg)
        return x + mlp_apply(p["ffn"], h, cfg), new_cache
    if ltype == "rec":
        h = apply_norm(p["norm1"], x, cfg)
        r, new_cache = rec_mod.rec_apply(p["rec"], h, cfg, cache=cache,
                                         plain=ctx.plain)
        x = x + r
        h = apply_norm(p["norm2"], x, cfg)
        return x + mlp_apply(p["ffn"], h, cfg), new_cache
    if ltype == "rwkv":
        h = apply_norm(p["norm1"], x, cfg)
        t, tc = rec_mod.rwkv_time_mix(p["time"], h, cfg, cache=cache,
                                      plain=ctx.plain)
        x = x + t
        h = apply_norm(p["norm2"], x, cfg)
        c, cc = rec_mod.rwkv_channel_mix(p["time"], h, cfg, cache=cache)
        x = x + c
        new_cache = None if cache is None else {**tc, **cc}
        return x, new_cache
    raise ValueError(ltype)
