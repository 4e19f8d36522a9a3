import dataclasses

from repro_torch.configs.base import ModelConfig

# LLaVA-NeXT-34B class [hf:llava-hf/llava-v1.6-*]: Yi-34B-shape decoder
# backbone; the anyres vision tower is a STUB per the brief --
# input_specs() provides precomputed patch embeddings (B, 2880, d_model)
# prepended to the token embeddings.  56 heads pad to 64.
CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60, d_model=7168, n_heads_raw=56, n_kv=8, d_head=128,
    d_ff=20480, vocab_raw=64_000,
    rope_theta=5_000_000.0,
    n_patches=2880,
    n_micro=8,   # activation temps: 34B x d7168 at nm=4 overflow HBM
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    skip_notes="long_500k skipped: full attention (quadratic decode).",
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=3, d_model=64, n_heads_raw=4, n_kv=2, d_head=16,
    d_ff=128, vocab_raw=512, n_patches=8, n_micro=1)
