"""zamba2-7b [hybrid] — Mamba2 blocks with a shared full-MHA attention
block every 9th layer (81 = 9 x (8 mamba + 1 attn)), ssm_state=64.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14_336, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_chunk=256,
    block_pattern=("mamba",) * 8 + ("attn",),
    grad_accum=4,
)
