"""whisper-base [audio] — encoder-decoder; the conv/mel frontend is a STUB
per the assignment (input_specs provides precomputed frame embeddings).
Absolute sinusoidal positions (no RoPE). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51_865,
    use_rope=False,
    block_pattern=("attn",),              # decoder blocks become xattn
    # 1536 (not whisper's 1500), as the JAX package has it; the frontend
    # is a stub
    encoder_layers=6, encoder_seq=1536,
    grad_accum=1,
)
