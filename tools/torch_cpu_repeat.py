#!/usr/bin/env python3
"""Run the small CP-APR that ``chip_smoke.py`` holds the card against
(``phase_small_cp_apr``) on the CPU only, under several CPU thread counts
and twice each, and print its log-likelihoods bit for bit.

    python3 tools/torch_cpu_repeat.py [--root DIR] [--threads 1,4,0]

The tensor is ``chip_smoke.py``'s: the (60, 24, 77, 32) ``blocked_tensor``
with 20,000 nonzeros (seed 1, count data), 64 partitions, rank 16, the
port's plan for the CUDA backend, 3 outer iterations under each Π policy.
The starting factors are ``chip_smoke.py``'s (a CUDA generator seeded
with 9) where a card is present, else a CPU generator's. Thread count 0
means PyTorch's default. Uses only entry points every version of the
port since CP-APR has, so ``--root`` runs another checkout (a ``git
archive`` of an earlier commit) with the same inputs. Prints one JSON
line: per policy and thread count, each run's log-likelihoods (as
``repr`` strings), inner iterations and a digest of the factors' bytes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path.cwd()),
                    help="checkout whose src/ runs")
    ap.add_argument("--threads", default="1,4,0",
                    help="CPU thread counts, 0 for the default")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import alto, cpapr, plan
    from repro_torch.sparse import synthetic

    default = torch.get_num_threads()
    x = synthetic.blocked_tensor((60, 24, 77, 32), 20_000, block=8,
                                 n_blocks=20, seed=1, count_data=True)
    at = alto.build_device(x, n_partitions=64, device="cpu")
    gen_dev = "cuda" if torch.cuda.is_available() else "cpu"
    g = torch.Generator(device=gen_dev)
    g.manual_seed(9)
    fs = [(torch.rand((I, 16), generator=g, device=gen_dev) + 0.05).cpu()
          for I in x.dims]
    p = plan.make_plan(at.meta, 16, backend="cuda")
    out = {"root": str(root), "torch": torch.__version__,
           "factors_from": gen_dev, "default_threads": default,
           "traversals": list(p.traversals())}
    for policy in ("otf", "pre"):
        for n in (int(t) for t in args.threads.split(",")):
            torch.set_num_threads(n or default)
            runs = []
            for _ in range(2):
                res = cpapr.cp_apr(at, 16,
                                   cpapr.CpaprParams(k_max=3, l_max=10),
                                   pi_policy=policy, track_ll=True,
                                   warm_start=[f.clone() for f in fs], plan=p)
                h = hashlib.sha256()
                for f in res.factors:
                    h.update(f.numpy().tobytes())
                runs.append({"ll": [repr(v) for v in res.log_likelihoods],
                             "inner": res.n_inner_total,
                             "factors": h.hexdigest()[:16]})
            out[f"{policy}_threads{n or default}"] = runs
    torch.set_num_threads(default)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
