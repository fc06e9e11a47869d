"""Train and serve steps (`repro_torch.train.steps`)."""
