import dataclasses

from repro_torch.configs.base import ModelConfig

# Whisper-medium [arXiv:2212.04356]: encoder-decoder, 24+24 layers,
# LayerNorm + GELU + learned positions (pre-RoPE lineage).  The conv/mel
# frontend is a STUB per the brief -- input_specs() provides precomputed
# frame embeddings (B, 1500, d_model).  vocab 51865 pads to 51872.
CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24, enc_layers=24,
    d_model=1024, n_heads_raw=16, n_kv=16, d_head=64,
    d_ff=4096, vocab_raw=51_865,
    norm="layernorm", mlp="gelu", pos="learned", max_pos=32_768,
    n_frames=1500,
    tie_embeddings=True,
    n_micro=4,
        fsdp_params=False,   # ZeRO-2: TP slice fits HBM
    skip_notes=("long_500k skipped: enc-dec; decoder attends <=1500 "
                "encoder frames, 500k target tokens out of family. "
                "decode_32k exercised (out-of-family length, lowers)."),
)

SMOKE = dataclasses.replace(
    CONFIG, head_pad=1, param_dtype="float32",
        grad_dtype="float32", adam_master_f32=False, adam_moment_dtype="float32", n_layers=2, enc_layers=2, d_model=64, n_heads_raw=4, n_kv=4,
    d_head=16, d_ff=128, vocab_raw=512, n_frames=16, max_pos=256)
