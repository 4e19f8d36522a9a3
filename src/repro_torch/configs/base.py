"""Architecture configuration schema + the shape grid.

Every assigned architecture is a ``ModelConfig`` (one module per arch under
``repro_torch/configs/``).  A config is pure data — the model code in
``repro_torch/models`` interprets it; the launcher resolves ``--arch <id>``
through ``repro_torch.configs``.  A copy of the JAX package's configs:
the same fields, defaults and derived properties.

Head padding
------------
The production mesh has a 16-way ``model`` axis, and attention heads are the
natural TP unit, so head counts are padded up to the next multiple of 16
(zero-initialized heads; their ``wo`` rows are zero so they are exact no-ops
at init and train like normal capacity afterwards).  ``n_heads_raw`` keeps the
paper value; the roofline report charges the padding to the usefulness ratio.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

TP = 16  # production model-axis width; head counts padded to multiples of it


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) column of the assigned grid."""
    name: str
    kind: str             # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads_raw: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab_raw: int

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_mode: str = ""            # "ep" (experts sharded) | "tp" (d_ff sharded)
    moe_cap_factor: float = 1.25
    aux_loss_coef: float = 0.01

    # Attention flavor
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size; None = full attention
    attn_logit_softcap: Optional[float] = None

    # Block pattern, cycled over layers: "attn" | "rec" (RG-LRU) | "rwkv"
    pattern: tuple = ("attn",)
    lru_width: int = 0            # RG-LRU channel width (0 = d_model)
    conv_width: int = 4           # RG block temporal-conv taps

    # Norm / MLP flavor
    norm: str = "rmsnorm"         # rmsnorm | layernorm (whisper)
    mlp: str = "swiglu"           # swiglu | gelu (whisper)
    pos: str = "rope"             # rope | learned (whisper)
    max_pos: int = 0              # learned-pos table size

    # Enc-dec / frontends (stubs provide precomputed embeddings)
    enc_layers: int = 0
    n_frames: int = 0             # whisper: encoder frame embeddings
    n_patches: int = 0            # llava: patch-embedding prefix

    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # dtypes / memory policy
    param_dtype: str = "bfloat16"
    adam_master_f32: bool = True  # f32 master copy in the optimizer
    adam_moment_dtype: str = "float32"
    grad_dtype: str = "float32"   # gradient-accumulation dtype

    # training knobs
    n_micro: int = 1              # gradient-accumulation microbatches
    remat: bool = True
    fsdp_params: bool = True      # shard weights over "data" (FSDP/ZeRO-3
                                  # style, per-layer gathers).  False =
                                  # ZeRO-2: weights replicated across data
                                  # (still TP-sharded over "model"), only
                                  # optimizer state + grads stay sharded —
                                  # for archs whose TP slice fits HBM this
                                  # removes every per-layer weight gather
                                  # (EXPERIMENTS.md Perf iteration 2)
    head_pad: int = TP            # pad n_heads to a multiple of this
                                  # (smoke configs use 1: no padding)

    # which assigned shapes run (long_500k only for sub-quadratic archs)
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""

    # ---- derived ----
    @property
    def n_heads(self) -> int:
        return pad_to(self.n_heads_raw, self.head_pad)

    @property
    def vocab(self) -> int:
        return pad_to(self.vocab_raw, self.head_pad * 2)

    @property
    def d_lru(self) -> int:
        return self.lru_width or self.d_model

    @property
    def dec_layers(self) -> int:
        return self.n_layers

    def kv_eff(self, tp: int) -> int:
        """KV heads as stored/sharded: replicated up to the TP width when the
        raw count is smaller (each rank keeps its group's copy)."""
        return max(self.n_kv, min(tp, self.n_heads)) if tp > 1 else self.n_kv

    def layer_types(self) -> list:
        """Per-layer block type, cycling ``pattern`` over decoder layers."""
        p = self.pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    def stage_split(self):
        """Decoder stages as [(pattern, n_repeats), ...]: a scan of n_repeats
        super-blocks per stage.  The remainder after cycling ``pattern``
        becomes a trailing homogeneous stage (recurrentgemma: 12 x
        (rec,rec,attn) + 2 x (rec,))."""
        n_super = self.n_layers // len(self.pattern)
        stages = []
        if n_super:
            stages.append((self.pattern, n_super))
        tail = self.layer_types()[n_super * len(self.pattern):]
        if tail:
            assert len(set(tail)) == 1, "tail must be homogeneous"
            stages.append(((tail[0],), len(tail)))
        return stages

    # ---- parameter counting (for roofline MODEL_FLOPS) ----
    def param_count(self, padded: bool = True) -> int:
        H = self.n_heads if padded else self.n_heads_raw
        V = self.vocab if padded else self.vocab_raw
        D, Dh, F = self.d_model, self.d_head, self.d_ff
        kv = self.n_kv

        def attn():
            n = D * (H + 2 * kv) * Dh + H * Dh * D
            if self.qkv_bias:
                n += (H + 2 * kv) * Dh
            return n

        def mlp():
            return D * F * (3 if self.mlp == "swiglu" else 2)

        def moe():
            return self.n_experts * D * F * 3 + D * self.n_experts

        def rec():
            # w_x/w_g/w_a in-projections, w_o out, conv taps+bias, lambda
            W = self.d_lru
            return 3 * D * W + W * D + (self.conv_width + 2) * W

        def rwkv():
            # time mix: r/k/v/g/w in-projections + o out (attention width
            # A = H*Dh, padded), u/w0/ln_x; channel mix: in/out + receptance
            A = H * Dh
            return 6 * D * A + 3 * A + 2 * D * F + D * D

        n = V * D * (1 if self.tie_embeddings else 2)
        if self.pos == "learned":
            n += self.max_pos * D
        for lt in self.layer_types():
            if lt == "attn":
                n += attn() + (moe() if self.n_experts else mlp())
            elif lt == "rec":
                n += rec() + mlp()
            elif lt == "rwkv":
                n += rwkv()
        n += self.enc_layers * (attn() + mlp())
        if self.enc_layers:           # decoder cross-attention
            n += self.n_layers * attn()
        return n

    def active_param_count(self, padded: bool = True) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count(padded)
        full = self.param_count(padded)
        moe_all = self.n_layers * self.n_experts * self.d_model * self.d_ff * 3
        moe_act = self.n_layers * self.top_k * self.d_model * self.d_ff * 3
        return full - moe_all + moe_act
