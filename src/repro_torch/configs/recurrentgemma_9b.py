import dataclasses

from repro_torch.configs.base import ModelConfig

# RG-LRU + local attention, 1:2 pattern (2 recurrent : 1 local-attn per
# super-block), per Griffin / RecurrentGemma [arXiv:2402.19427].
# 38 layers = 12 x (rec, rec, attn) + (rec, rec) tail.
CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38, d_model=4096, n_heads_raw=16, n_kv=1, d_head=256,
    d_ff=12288, vocab_raw=256_000,
    pattern=("rec", "rec", "attn"),
    window=2048,                       # local attention window
    lru_width=4096,
    rope_theta=10_000.0,
    n_micro=4,
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    # RG-LRU state + 2048-window KV cache => O(window) decode: long_500k runs.
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=5, d_model=64, n_heads_raw=2, n_kv=1, d_head=32,
    d_ff=128, vocab_raw=512, lru_width=64, window=32, n_micro=1)
