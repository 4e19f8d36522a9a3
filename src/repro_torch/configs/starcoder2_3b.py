import dataclasses

from repro_torch.configs.base import ModelConfig

# StarCoder2-3B [arXiv:2402.19173]: GQA kv=2, RoPE, learned bias on QKV.
# 24 heads pad to 32 for the 16-way model axis (largest pad in the pool;
# charged to the roofline usefulness ratio).
CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30, d_model=3072, n_heads_raw=24, n_kv=2, d_head=128,
    d_ff=12288, vocab_raw=49_152,
    qkv_bias=True,
    rope_theta=100_000.0,
    norm="layernorm", mlp="gelu",      # starcoder2 keeps GPT-style blocks
    n_micro=4,
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    skip_notes="long_500k skipped: full attention (quadratic decode).",
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=3, d_model=64, n_heads_raw=4, n_kv=2, d_head=16,
    d_ff=128, vocab_raw=512, n_micro=1)
