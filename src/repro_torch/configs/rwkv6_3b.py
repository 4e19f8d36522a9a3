import dataclasses

from repro_torch.configs.base import ModelConfig

# RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent
# decay wkv recurrence + channel mix.  40 wkv heads (d_head 64) pad to 48
# for the model axis.  O(1) state => long_500k runs.
CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32, d_model=2560, n_heads_raw=40, n_kv=40, d_head=64,
    d_ff=8960, vocab_raw=65_536,
    pattern=("rwkv",),
    pos="none",
    n_micro=4,
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=3, d_model=64, n_heads_raw=4, n_kv=4, d_head=16,
    d_ff=128, vocab_raw=512, n_micro=1)
