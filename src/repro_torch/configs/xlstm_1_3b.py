"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 ratio), d_ff=0 (blocks
carry their own projections). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_proj_factor=2.0, ssm_chunk=256,
    # a training setting of the JAX package (mLSTM chunk states dominate
    # the activations); the port's forward ignores it
    grad_accum=4,
)
