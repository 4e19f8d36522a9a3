"""GQA self-attention: RoPE / qk-norm / QKV-bias / sliding-window flavors.

Port of ``repro/models/attention.py``, one card (``tp = 1``).  Prefill
attention goes through the ``flash_attention`` op (kernels/): on the card
its CUDA kernel, on the CPU its plain version.  Decode attention is plain
torch, ``_dense`` over the cache, as in the JAX package.

Caches are bfloat16 whatever the parameter dtype, as in the JAX package;
decode reads them back in q's dtype.  Decode writes its token's K/V into
the cache in place (the JAX step returns an updated copy), which saves a
copy of every layer's cache per token.  The cross-attention branch
(whisper) raises ``NotImplementedError`` (ROADMAP A.12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import common
from repro_torch.models.common import ParamSpec, widen

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Per-call context.  ``plain`` runs the kernels' plain versions even
    on CUDA tensors: the reference route that the kernel route is held
    against on the card."""
    tp: int = 1                 # model-axis width (kv_eff)
    mode: str = "train"         # train | prefill | decode
    pos: Optional[int] = None   # decode position
    plain: bool = False


def raise_cross():
    raise NotImplementedError(
        "cross-attention (whisper's encoder-decoder) is not ported to "
        "repro_torch yet: it waits for ROADMAP A.12")


# ------------------------------------------------------------------- schema
def attn_schema(cfg, cross: bool = False) -> dict:
    if cross:
        raise_cross()
    D, H, kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    pd = cfg.param_dtype
    zr = (1, cfg.n_heads_raw) if cfg.n_heads_raw < H else None
    s = {
        "wq": ParamSpec((D, H, Dh), ("embed", "heads", "head"), dtype=pd,
                        fan_in_dims=(0,), zero_rows=zr),
        "wk": ParamSpec((D, kv, Dh), ("embed", "kv", "head"), dtype=pd,
                        fan_in_dims=(0,)),
        "wv": ParamSpec((D, kv, Dh), ("embed", "kv", "head"), dtype=pd,
                        fan_in_dims=(0,)),
        "wo": ParamSpec((H, Dh, D), ("heads", "head", "embed"), dtype=pd,
                        fan_in_dims=(0, 1),
                        zero_rows=(0, cfg.n_heads_raw) if zr else None),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, Dh), ("heads", "head"), "zeros", pd)
        s["bk"] = ParamSpec((kv, Dh), ("kv", "head"), "zeros", pd)
        s["bv"] = ParamSpec((kv, Dh), ("kv", "head"), "zeros", pd)
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((Dh,), ("none",), "zeros", "float32")
        s["k_norm"] = ParamSpec((Dh,), ("none",), "zeros", "float32")
    return s


def cache_schema(cfg, batch: int, s_cache: int, tp: int, device) -> dict:
    shp = (batch, cfg.kv_eff(tp), s_cache, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shp, dtype=torch.bfloat16, device=device)}


# ------------------------------------------------------------- inner softmax
def _dense(q, k, v, mask):
    """q: [B,G,R,Sq,Dh]; k,v: [B,G,Sk,Dh]; mask broadcastable [Sq,Sk].
    Products accumulate in float32; p is cast to v's dtype before P.V."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", widen(q), widen(k))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrqk,bgkd->bgrqd", widen(p.to(v.dtype)),
                        widen(v)).to(q.dtype)


def _flash(q, k, v, *, causal: bool, window: Optional[int],
           plain: bool = False):
    """q: [B,G,R,Sq,Dh]; k,v: [B,G,Sk,Dh].  The ``flash_attention`` op on
    q scaled in its own dtype (as the JAX ``_flash``), head g*R + r
    reading kv head g."""
    B, G, R, Sq, Dh = q.shape
    qs = (q * Dh ** -0.5).reshape(B, G * R, Sq, Dh).contiguous()
    op = flash_attention_plain if plain else flash_attention
    o = op(qs, k.contiguous(), v.contiguous(), causal=causal, window=window,
           scale=1.0)
    return o.reshape(B, G, R, Sq, Dh)


# ------------------------------------------------------------------ the op
def _group(q, kv_eff):
    B, S, H, Dh = q.shape
    rep = H // kv_eff
    return q.reshape(B, S, kv_eff, rep, Dh).permute(0, 2, 3, 1, 4)


def _repeat_kv(k, kv_eff):
    B, S, kv, Dh = k.shape
    if kv == kv_eff:
        return k.transpose(1, 2)
    return torch.repeat_interleave(k.transpose(1, 2), kv_eff // kv, dim=1)


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w)."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(
        (B, S) + tuple(w.shape[1:]))


def attention(p, x, cfg, ctx: ModelCtx, *, causal: bool = True,
              window: Optional[int] = None, kv_src=None, use_rope=True,
              cache=None, pos=None, is_cross: bool = False):
    """Returns (out [B,S,D], new_cache).

    cache: {"k","v"} [B, kv_eff, S_c, Dh].  Prefill fills a new cache
    (rolling when S_c == window: position p at slot p % S_c); decode
    writes slot ``pos`` (``pos % S_c`` when rolling) in place.
    """
    if is_cross or kv_src is not None:
        raise_cross()
    B, S, D = x.shape
    Dh = cfg.d_head
    G = cfg.kv_eff(ctx.tp)

    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if "q_norm" in p:
        q = common.rmsnorm(q, p["q_norm"], cfg.norm_eps)

    if cache is not None and ctx.mode == "decode":
        knew = _proj(x, p["wk"])
        vnew = _proj(x, p["wv"])
        if "bk" in p:
            knew, vnew = knew + p["bk"], vnew + p["bv"]
        if "k_norm" in p:
            knew = common.rmsnorm(knew, p["k_norm"], cfg.norm_eps)
        if use_rope:
            pp = torch.full((B, S), pos, dtype=torch.int32, device=x.device)
            q = common.rope(q, pp, cfg.rope_theta)
            knew = common.rope(knew, pp, cfg.rope_theta)
        knew = _repeat_kv(knew, G)[:, :, 0]          # [B, G, Dh]
        vnew = _repeat_kv(vnew, G)[:, :, 0]
        ck, cv = cache["k"], cache["v"]
        S_c = ck.shape[2]
        slot = (pos % S_c if (window is not None and S_c == window)
                else min(pos, S_c - 1))
        ck[:, :, slot] = knew.to(ck.dtype)
        cv[:, :, slot] = vnew.to(cv.dtype)
        ar = torch.arange(S_c, device=x.device)
        valid = (ar <= pos) | (pos >= S_c)
        qg = _group(q, G)                             # [B,G,R,1,Dh]
        o = _dense(qg * Dh ** -0.5, ck.to(qg.dtype), cv.to(qg.dtype),
                   valid[None, :])
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        o, kr, vr = _self_attn(p, x, q, cfg, G, causal, window, use_rope,
                               ctx.plain)
        dt = cache["k"].dtype
        S_c = cache["k"].shape[2]
        ar = torch.arange(S_c, device=x.device)
        if window is not None and S_c == window:
            if S >= S_c:
                base = S - S_c
                take = base + torch.remainder(ar - base, S_c)
                ck, cv = kr[:, :, take].to(dt), vr[:, :, take].to(dt)
            else:         # partially-filled rolling cache: slot p = p
                take = torch.clamp(ar, 0, S - 1)
                keep = (ar < S)[None, None, :, None]
                ck = torch.where(keep, kr[:, :, take], 0).to(dt)
                cv = torch.where(keep, vr[:, :, take], 0).to(dt)
        else:
            pad = (0, 0, 0, S_c - S)
            ck = torch.nn.functional.pad(kr, pad).to(dt)
            cv = torch.nn.functional.pad(vr, pad).to(dt)
        new_cache = {"k": ck.contiguous(), "v": cv.contiguous()}
    else:
        o, _, _ = _self_attn(p, x, q, cfg, G, causal, window, use_rope,
                             ctx.plain)
        new_cache = None

    B_, G_, R_, S_, Dh_ = o.shape
    o = o.permute(0, 3, 1, 2, 4).reshape(B_ * S_, G_ * R_ * Dh_)
    out = (o @ p["wo"].reshape(G_ * R_ * Dh_, D)).reshape(B, S, D)
    return out, new_cache


def _self_attn(p, x, q, cfg, G, causal, window, use_rope, plain=False):
    B, S, _ = x.shape
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if "k_norm" in p:
        k = common.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        pp = torch.arange(S, device=x.device)[None].expand(B, S)
        q = common.rope(q, pp, cfg.rope_theta)
        k = common.rope(k, pp, cfg.rope_theta)
    kg, vg = _repeat_kv(k, G), _repeat_kv(v, G)
    o = _flash(_group(q, G), kg, vg, causal=causal, window=window,
               plain=plain)
    return o, kg, vg
