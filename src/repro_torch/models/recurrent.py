"""Recurrent blocks: RG-LRU (Griffin / recurrentgemma) and RWKV-6 time and
channel mix.  Port of ``repro/models/recurrent.py``.  The recurrences go
through the ``rglru`` and ``rwkv6`` ops (kernels/): on the card their CUDA
kernels, on the CPU (or with ``plain``) their plain versions.

Decode caches (token-shift and conv tails bfloat16, as in the JAX
package):
  rec : {"h": [B, W] f32 LRU state, "conv": [B, cw-1, W] conv tail}
  rwkv: {"state": [B, H, Dh, Dh] f32 wkv state,
         "prev_t"/"prev_c": [B, D] token-shift tails}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_plain
from repro_torch.models.common import ParamSpec, rmsnorm, widen


# ------------------------------------------------------------------- RG-LRU
def rec_schema(cfg) -> dict:
    D, W, cw = cfg.d_model, cfg.d_lru, cfg.conv_width
    pd = cfg.param_dtype
    return {
        "w_x": ParamSpec((D, W), ("embed", "lru"), dtype=pd,
                         fan_in_dims=(0,)),
        "w_g": ParamSpec((D, W), ("embed", "lru"), dtype=pd,
                         fan_in_dims=(0,)),
        "w_a": ParamSpec((D, W), ("embed", "lru"), dtype=pd,
                         fan_in_dims=(0,)),
        "lam": ParamSpec((W,), ("lru",), "lambda_lru", "float32"),
        "conv_w": ParamSpec((cw, W), ("none", "lru"), dtype=pd,
                            fan_in_dims=(0,)),
        "conv_b": ParamSpec((W,), ("lru",), "zeros", pd),
        "w_o": ParamSpec((W, D), ("lru", "embed"), dtype=pd,
                         fan_in_dims=(0,)),
    }


def rec_cache(cfg, batch: int, device) -> dict:
    return {"h": torch.zeros((batch, cfg.d_lru), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_lru),
                                dtype=torch.bfloat16, device=device)}


def rec_apply(p, x, cfg, cache=None, plain: bool = False):
    """x: normed input [B, S, D] -> (out [B, S, D], new_cache)."""
    B, S, D = x.shape
    cw = cfg.conv_width
    xx = x @ p["w_x"]

    tail = (cache["conv"].to(xx.dtype) if cache is not None
            else torch.zeros((B, cw - 1, xx.shape[-1]), dtype=xx.dtype,
                             device=x.device))
    ext = torch.cat([tail, xx], dim=1)                   # [B, S+cw-1, W]
    conv = sum(ext[:, i:i + S] * p["conv_w"][i] for i in range(cw))
    conv = conv + p["conv_b"]

    gate_a = torch.sigmoid(widen(x @ p["w_a"]))
    log_a = -8.0 * F.softplus(p["lam"]) * gate_a          # [B, S, W] f32

    h0 = cache["h"] if cache is not None else None
    h, h_last = (rglru_plain if plain else rglru)(log_a, conv, h0)

    g = F.gelu(x @ p["w_g"], approximate="tanh")
    out = (h * g).to(x.dtype) @ p["w_o"]
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_last,
                     "conv": ext[:, -(cw - 1):].to(cache["conv"].dtype)}
    return out, new_cache


# -------------------------------------------------------------------- RWKV6
def rwkv_schema(cfg) -> dict:
    D, F_, H, Dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_head
    pd = cfg.param_dtype
    proj = dict(dtype=pd, fan_in_dims=(0,))
    return {
        "mu": ParamSpec((5, D), ("none", "none"), "zeros", "float32"),
        "w_r": ParamSpec((D, H, Dh), ("embed", "heads", "head"), **proj),
        "w_k": ParamSpec((D, H, Dh), ("embed", "heads", "head"), **proj),
        "w_v": ParamSpec((D, H, Dh), ("embed", "heads", "head"), **proj),
        "w_g": ParamSpec((D, H, Dh), ("embed", "heads", "head"), **proj),
        "w_w": ParamSpec((D, H, Dh), ("embed", "heads", "head"), **proj),
        "w0": ParamSpec((H, Dh), ("heads", "head"), "decay_bias", "float32"),
        "u": ParamSpec((H, Dh), ("heads", "head"), dtype="float32"),
        "ln_x": ParamSpec((H, Dh), ("heads", "head"), "zeros", "float32"),
        "w_o": ParamSpec((H, Dh, D), ("heads", "head", "embed"), dtype=pd,
                         fan_in_dims=(0, 1)),
        "mu_c": ParamSpec((2, D), ("none", "none"), "zeros", "float32"),
        "w_cin": ParamSpec((D, F_), ("embed", "mlp"), **proj),
        "w_cr": ParamSpec((D, D), ("embed", "none"), **proj),
        "w_cout": ParamSpec((F_, D), ("mlp", "embed"), **proj),
    }


def rwkv_cache(cfg, batch: int, device) -> dict:
    H, Dh, D = cfg.n_heads, cfg.d_head, cfg.d_model
    return {"state": torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                                 device=device),
            "prev_t": torch.zeros((batch, D), dtype=torch.bfloat16,
                                  device=device),
            "prev_c": torch.zeros((batch, D), dtype=torch.bfloat16,
                                  device=device)}


def _shift(x, prev):
    """Token shift: x_{t-1} (prev carries across calls)."""
    B, S, D = x.shape
    first = (prev.to(x.dtype)[:, None] if prev is not None
             else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device))
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(x, w):
    """einsum("bsd,dhk->bhsk", x, w), contiguous."""
    B, S, D = x.shape
    H, Dh = w.shape[1], w.shape[2]
    return (x @ w.reshape(D, H * Dh)).reshape(B, S, H, Dh).transpose(
        1, 2).contiguous()


def rwkv_time_mix(p, x, cfg, cache=None, plain: bool = False):
    """x: normed [B,S,D] -> (out, {"state", "prev_t"})."""
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    xs = _shift(x, cache["prev_t"] if cache is not None else None)

    def lerp(i):
        return x + (xs - x) * p["mu"][i].to(x.dtype)

    r = _heads(lerp(0), p["w_r"])
    k = _heads(lerp(1), p["w_k"])
    v = _heads(lerp(2), p["w_v"])
    g = F.silu((lerp(3) @ p["w_g"].reshape(D, H * Dh)).reshape(B, S, H, Dh))
    wexp = widen(_heads(lerp(4), p["w_w"]))
    w = torch.exp(-torch.exp(p["w0"][None, :, None] + wexp))  # (0,1) decay

    s0 = cache["state"] if cache is not None else None
    out, s_last = (rwkv6_plain if plain else rwkv6)(r, k, v, w, p["u"], s0)
    out = out.transpose(1, 2)                                 # [B,S,H,Dh]
    out = rmsnorm(out, p["ln_x"].expand(out.shape[-2:]),
                  cfg.norm_eps) * g.to(out.dtype)
    y = (out.to(x.dtype).reshape(B * S, H * Dh)
         @ p["w_o"].reshape(H * Dh, D)).reshape(B, S, D)
    new = None
    if cache is not None:
        new = {"state": s_last, "prev_t": x[:, -1].to(torch.bfloat16)}
    return y, new


def rwkv_channel_mix(p, x, cfg, cache=None):
    xs = _shift(x, cache["prev_c"] if cache is not None else None)
    mk = x + (xs - x) * p["mu_c"][0].to(x.dtype)
    mr = x + (xs - x) * p["mu_c"][1].to(x.dtype)
    k = torch.square(torch.relu(mk @ p["w_cin"]))
    kv = k @ p["w_cout"]
    out = torch.sigmoid(mr @ p["w_cr"]) * kv
    new = None
    if cache is not None:
        new = {"prev_c": x[:, -1].to(torch.bfloat16)}
    return out, new
