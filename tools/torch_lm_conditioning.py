#!/usr/bin/env python3
"""How far one float32 rounding moves the LM stack's logits.

    PYTHONPATH=src python tools/torch_lm_conditioning.py [--device cpu]

For the first two layers of granite-moe-3b-a800m and smollm-360m at full
width in float32 (the models of `chip_smoke.py`'s card-against-CPU check,
seeded as there), and for smollm-360m at its full depth of 32 layers,
prints the largest attention logit of layer 0 and the relative change of
the logits, ``max|Δ| / max|logits|``, when every weight is moved by one
float32 rounding (multiplied by ``1 ± 2**-24``, the sign drawn from a
seed), over a few draws. Two computations that round differently (two
devices, or forward against prefill + decode) cannot be expected to
agree closer than this. It measures the model's conditioning, no device
rate; the default device is the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

RUNS = (("granite-moe-3b-a800m", 2), ("smollm-360m", 2),
        ("smollm-360m", 32))


def _max_attn_logit(cfg, model, batch) -> float:
    x = C.rmsnorm(model.layers[0]["ln1"],
                  C.embed(model.embed, batch["tokens"]), cfg.norm_eps)
    q, k, _ = A._project_qkv(cfg, model.layers[0]["attn"], x)
    G = cfg.n_heads // cfg.n_kv_heads
    k = k.repeat_interleave(G, dim=2)
    return float((torch.einsum("bqhd,bkhd->bhqk", q, k)
                  * cfg.head_dim ** -0.5).abs().max())


@torch.inference_mode()
def conditioning(arch: str, device, draws: int, layers: int = 2) -> dict:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    model = M.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    batch = make_batch(cfg, 2, 64, 0, 0, device=device)
    batch.pop("labels")
    base, _ = M.forward(cfg, model, batch)
    saved = [p.detach().clone() for p in model.parameters()]
    moved = []
    for d in range(draws):
        g = torch.Generator(device=device).manual_seed(100 + d)
        for p, w in zip(model.parameters(), saved):
            sign = torch.randint(0, 2, w.shape, generator=g,
                                 device=device) * 2 - 1
            p.copy_(w * (1 + sign * 2.0 ** -24))
        out, _ = M.forward(cfg, model, batch)
        moved.append(float((out - base).abs().max() / base.abs().max()))
    for p, w in zip(model.parameters(), saved):
        p.copy_(w)
    return {"layers": layers, "max_attention_logit_layer0":
            _max_attn_logit(cfg, model, batch),
            "logits_rel_change_one_rounding": moved}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args(argv)
    out = {f"{a} ({n} layers)": conditioning(a, torch.device(args.device),
                                             args.draws, n)
           for a, n in RUNS}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
