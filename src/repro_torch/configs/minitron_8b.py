"""minitron-8b [dense] — pruned nemotron, GQA (kv=8).
[arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16_384, vocab_size=256_000,
    rope_theta=10_000.0,
    block_pattern=("attn",),
    grad_accum=2,
)
