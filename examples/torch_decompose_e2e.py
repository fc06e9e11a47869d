"""End-to-end driver on the PyTorch port: decompose a large synthetic
count tensor to convergence with checkpoints — restartable at any
checkpoint.

  PYTHONPATH=src python examples/torch_decompose_e2e.py [--iters 30]
  PYTHONPATH=src python examples/torch_decompose_e2e.py --device cpu \
      --nnz 5000 --iters 10 --ckpt-dir /tmp/e2e                   # CPU

Every 5 iterations the factors and the fits so far are checkpointed
(`repro_torch.checkpoint`); a run finding a checkpoint in ``--ckpt-dir``
resumes from the newest one. Run with ``--iters 5`` and then with
``--iters 30`` on the same directory: the second run resumes at
iteration 5 and ends with the factors and fits of one uninterrupted run,
bit for bit (the same kernels on the same float32 factors).
"""
import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.core import alto, cpals
from repro_torch.sparse import synthetic

CHUNK = 5          # iterations between checkpoints


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--nnz", type=int, default=500_000)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "alto_torch_e2e_ckpt"))
    args = ap.parse_args(argv)

    x = synthetic.zipf_tensor((4096, 2048, 1024, 64), args.nnz, a=1.3,
                              seed=0, count_data=True)
    print(f"tensor: dims={x.dims} nnz={x.nnz}")
    t0 = time.time()
    at = alto.build_device(x, n_partitions=32, device=args.device)
    print(f"ALTO build: {time.time() - t0:.2f}s "
          f"(index {at.meta.enc.total_bits} bits, fiber reuse per mode "
          f"{[f'{r:.1f}' for r in at.meta.fiber_reuse]})")

    # resume if a checkpoint exists
    factors, fits, start = None, [], 0
    last = ck.latest_step(args.ckpt_dir)
    if last is not None:
        like = cpals.init_factors(x.dims, args.rank, seed=0,
                                  device=args.device)
        factors, manifest = ck.restore(args.ckpt_dir, last, like,
                                       device=args.device)
        start, fits = manifest["step"], manifest["extra"]["fits"]
        print(f"resumed from iteration {start}")

    for it in range(start, args.iters, CHUNK):
        res = cpals.cp_als(at, rank=args.rank, n_iters=CHUNK, tol=0,
                           seed=0, factors=factors)
        factors = res.factors
        fits += res.fits
        ck.save(args.ckpt_dir, it + CHUNK, factors, extra={"fits": fits})
        print(f"iters {it + 1}-{it + CHUNK}: fit {res.fits[-1]:.4f} "
              f"(checkpointed)")
    if fits:
        print(f"final fit {fits[-1]:.4f} in {time.time() - t0:.1f}s total")
    return {"at": at, "factors": factors, "fits": fits, "start": start}


if __name__ == "__main__":
    main()
