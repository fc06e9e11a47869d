"""The LM stack's models: attention, dense MLP, MoE with ALTO-sorted
dispatch, Mamba2 SSD, mLSTM, sLSTM, an encoder-decoder and M-RoPE, in
plain PyTorch (no Pallas kernel lies on this path in the JAX package)."""
