import dataclasses

from repro_torch.configs.base import ModelConfig

# Qwen3-32B class [hf:Qwen/Qwen3-*]: qk-norm (RMSNorm on per-head q/k),
# GQA kv=8, no QKV bias.
CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64, d_model=5120, n_heads_raw=64, n_kv=8, d_head=128,
    d_ff=25600, vocab_raw=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_micro=4,
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    skip_notes="long_500k skipped: full attention (quadratic decode).",
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=3, d_model=64, n_heads_raw=4, n_kv=2, d_head=16,
    d_ff=128, vocab_raw=512, n_micro=1)
