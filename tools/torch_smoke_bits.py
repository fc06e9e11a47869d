#!/usr/bin/env python3
"""Compare the card sequences of two ``chip_smoke.py`` runs bit for bit.

    python3 tools/torch_smoke_bits.py A.json B.json

Reads two ``chiprun_out/chip_smoke.json`` files (for example a parent
commit's run and its change's, made in one call) and compares every
sequence the decompositions produced on the card: CP-ALS fits, CP-APR
log-likelihoods and KKT violations, in core under both routings, streamed
and small (keys ``fits``, ``fits_cuda``, ``log_likelihoods``,
``ll_cuda``, ``kkt_violations``); each shape-class bucket's per-tenant
fits, KKT violations and inner-step counts (``batched``: lists of
lists, and ``n_inner_total``); and the warm- and cold-start CP-ALS fits
of the ingest phase (``warm_fits``, ``cold_fits``), as exact equality.
Prints the
count compared, the keys found in only one file and the keys that
differ, and exits 1 when any differs or is missing. Runs anywhere.
"""
from __future__ import annotations

import json
import sys

KEYS = ("fits", "fits_cuda", "log_likelihoods", "ll_cuda", "kkt_violations",
        "n_inner_total", "warm_fits", "cold_fits")


def sequences(node, path=()) -> dict[str, list]:
    """Every list under a key of `KEYS`, by its dotted path."""
    found = {}
    if isinstance(node, dict):
        for k, v in node.items():
            if k in KEYS and isinstance(v, list):
                found[".".join(path + (k,))] = v
            else:
                found.update(sequences(v, path + (k,)))
    return found


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (sequences(json.load(open(p))) for p in sys.argv[1:])
    only = sorted(set(a) ^ set(b))
    differ = sorted(k for k in set(a) & set(b) if a[k] != b[k])
    print(f"sequences {len(set(a) & set(b))} compared; keys only in one: "
          f"{only} differing: {differ}")
    return 1 if only or differ else 0


if __name__ == "__main__":
    sys.exit(main())
