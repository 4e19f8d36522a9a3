import dataclasses

from repro_torch.configs.base import ModelConfig

# Mixtral 8x22B [arXiv:2401.04088]: 8 experts top-2, sliding-window
# attention.  8 experts < 16-way model axis => TP-in-expert sharding
# (d_ff sharded, experts replicated), per DESIGN.md.
CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56, d_model=6144, n_heads_raw=48, n_kv=8, d_head=128,
    d_ff=16384, vocab_raw=32_768,
    n_experts=8, top_k=2, moe_mode="tp",
    window=4096,                      # SWA => rolling cache, O(window)
    rope_theta=1_000_000.0,
    n_micro=8,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, moe_cap_factor=4.0, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=4, d_model=64, n_heads_raw=4, n_kv=2, d_head=16,
    d_ff=128, vocab_raw=512, n_experts=4, top_k=2, window=32, n_micro=1)
