"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE: 384 experts top-8,
d_expert=2048, 61 layers (prime → pattern length 1). The optimizer and
accumulation fields are training settings, which the port's forward
ignores. [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163_840,
    n_experts=384, experts_per_token=8, d_expert=2048,
    block_pattern=("moe",),
    optimizer="adafactor", grad_accum=8,
    opt_update_chunks=4,    # sequence optimizer-update temporaries (§Perf)
)
