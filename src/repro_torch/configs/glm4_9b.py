"""glm4-9b [dense] — RoPE, GQA (kv=2). [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab_size=151_552,
    rope_theta=10_000.0,
    block_pattern=("attn",),
    grad_accum=2,
)
