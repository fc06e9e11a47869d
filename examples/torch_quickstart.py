"""Quickstart on the PyTorch port: build an ALTO tensor on the card and
decompose it with CP-ALS.

  PYTHONPATH=src python examples/torch_quickstart.py             # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
      --dims 40,30,20,16 --nnz 3000                              # small, CPU

The default tensor is the UBER-like 4-way count tensor of the paper's
high-reuse regime (`synthetic.paper_like("uber_like")`).
"""
import argparse

from repro_torch.core import alto, cpals, heuristics
from repro_torch.sparse import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default="183,24,1024,1536")
    ap.add_argument("--nnz", type=int, default=260_000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    # 1. A skewed 4-way count tensor (UBER-like regime from the paper).
    dims = tuple(int(d) for d in args.dims.split(","))
    x = synthetic.blocked_tensor(dims, args.nnz, block=12, n_blocks=8,
                                 seed=0, count_data=True)
    print(f"tensor: dims={x.dims} nnz={x.nnz} density={x.density:.2e}")

    # 2. ALTO format generation on the device: linearize -> one key sort
    #    -> balanced partitions.
    at = alto.build_device(x, n_partitions=16, device=args.device)
    enc = at.meta.enc
    print(f"ALTO index: {enc.total_bits} bits in {enc.n_words} 32-bit "
          f"word(s); COO would need {enc.storage_bits_coo(32)} bits "
          f"(compression "
          f"{enc.storage_bits_coo(32) / enc.storage_bits_alto(32):.2f}x)")
    print(f"fiber reuse per mode: "
          f"{[f'{r:.1f}' for r in at.meta.fiber_reuse]} "
          f"-> class {heuristics.tensor_reuse_class(at.meta)}")
    for m in range(x.ndim):
        print(f"  mode {m}: traversal = "
              f"{heuristics.choose_traversal(at.meta, m).value}")

    # 3. Decompose.
    res = cpals.cp_als(at, rank=args.rank, n_iters=args.iters, seed=0)
    print(f"CP-ALS: {res.n_iters} iters, fit {res.fits[-1]:.4f}")
    print(f"lambda: {res.lam.cpu().numpy().round(2)}")
    return res


if __name__ == "__main__":
    main()
