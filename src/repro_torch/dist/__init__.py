"""Distributed CPD over a `torch.distributed` process group
(`repro_torch.dist.cpd`)."""
