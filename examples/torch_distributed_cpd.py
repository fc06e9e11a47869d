"""Distributed CP-ALS on the PyTorch port: the nonzero stream cut into
row-range slices across the ranks of a `torch.distributed` group, the
partial MTTKRPs summed with an all-reduce (`repro_torch.dist.cpd`).

  PYTHONPATH=src torchrun --nproc-per-node=N \
      examples/torch_distributed_cpd.py                     # N cards
  PYTHONPATH=src torchrun --nproc-per-node=2 \
      examples/torch_distributed_cpd.py --device cpu        # 2 gloo ranks
  PYTHONPATH=src python examples/torch_distributed_cpd.py    # one rank

NCCL on the card (rank r on card ``LOCAL_RANK``), gloo on the CPU.
Started without torchrun, the script runs as a group of one rank.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.dist.cpd import distributed_cp_als
from repro_torch.sparse import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    cpu = torch.device(args.device).type == "cpu"
    device = args.device
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    backend = "gloo" if cpu else "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:                      # started by torchrun
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                    world_size=1, rank=0)
        try:
            rank, world = dist.get_rank(), dist.get_world_size()
            x = synthetic.zipf_tensor((512, 256, 128), args.nnz, seed=0)
            if rank == 0:
                print(f"{world} rank(s) over {backend}; tensor: "
                      f"dims={x.dims} nnz={x.nnz}")
            lam, factors, fits = distributed_cp_als(
                x, rank=8, n_iters=args.iters, device=device)
        finally:
            dist.destroy_process_group()
    if rank == 0:
        for i, f in enumerate(fits):
            print(f"iter {i}: fit {f:.4f}")
        print("distributed decomposition complete;",
              f"factor shapes: {[tuple(f.shape) for f in factors]}")
    return fits


if __name__ == "__main__":
    main()
