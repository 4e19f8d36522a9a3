import dataclasses

from repro_torch.configs.base import ModelConfig

# Llama-4 Maverick class MoE: 128 experts, top-1 routing, early fusion
# (text-only backbone here; the fusion frontend is out of assigned scope).
# [hf:meta-llama/Llama-4-*; unverified pool entry].  40 heads pad to 48
# for the 16-way model axis.
CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48, d_model=5120, n_heads_raw=40, n_kv=8, d_head=128,
    d_ff=8192, vocab_raw=202_048,
    n_experts=128, top_k=1, moe_mode="ep",
    rope_theta=500_000.0,
    n_micro=8,
    # ~773B total / ~17B-class active: bf16 moments, no f32 master --
    # the v5e HBM budget at 512 chips (see EXPERIMENTS.md dry-run table).
    adam_master_f32=False, adam_moment_dtype="bfloat16",
        grad_dtype="bfloat16",
    skip_notes="long_500k skipped: full attention (quadratic decode).",
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, moe_cap_factor=4.0, param_dtype="float32", grad_dtype="float32", n_layers=4, d_model=64, n_heads_raw=4, n_kv=2, d_head=16,
    d_ff=128, vocab_raw=512, n_experts=8, top_k=1, n_micro=1,
    adam_master_f32=True, adam_moment_dtype="float32")
