"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_expert=512; the MoE
dispatch runs through the ALTO-linearized sorted path (`models/moe.py`).
[hf:ibm-granite/granite-3.0-*-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49_155,
    n_experts=40, experts_per_token=8, d_expert=512,
    block_pattern=("moe",), tie_embeddings=True,
    grad_accum=1,
)
