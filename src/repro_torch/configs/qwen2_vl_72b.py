"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution. Backbone only: the
vision tower is a STUB (input_specs provides patch embeddings + 3-D
positions). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29_568, vocab_size=152_064,
    qkv_bias=True, rope_theta=1_000_000.0,
    mrope=True, mrope_sections=(16, 24, 24), vision_prefix=256,
    block_pattern=("attn",),
    grad_accum=8,
)
