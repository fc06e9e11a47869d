"""Serving launcher: batched prefill + greedy decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --prompt-len 128 --gen 32

The request path: prefill builds the KV/recurrent cache, then each decode
step extends every row by one token, chosen greedily. The default device
is ``cuda``; without CUDA the launcher raises unless ``--device cpu`` is
given. Weights are drawn from ``torch.Generator`` seeded with ``--seed``
(bf16 unless the configuration says float32); JAX's PRNG cannot be
reproduced, so they differ from the JAX launcher's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor      # (B, gen) int32, the greedy continuation
    logits: torch.Tensor      # (gen, B, vocab) float32, each step's logits
    prefill_s: float          # prefill and the first token
    decode_s: float           # the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(cfg, model: M.Model, batch: dict, gen: int) -> Generation:
    """Prefill ``batch`` (its ``labels`` are ignored), then ``gen - 1``
    greedy decode steps: ``gen`` tokens a row. The caches hold the prompt
    (vision prefix included) plus ``gen`` positions."""
    batch = {k: v for k, v in batch.items() if k != "labels"}
    dev = batch["tokens"].device
    P = batch["tokens"].shape[1] + (
        batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, model, batch, s_max=P + gen)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out_tokens, out_logits = [next_tok], [logits]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = M.decode_step(cfg, model, next_tok, cache, P + i)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out_tokens.append(next_tok)
        out_logits.append(logits)
    _sync(dev)
    return Generation(torch.cat(out_tokens, dim=1), torch.stack(out_logits),
                      prefill_s, time.perf_counter() - t0)


def serve(args) -> torch.Tensor:
    dev = resolve_device(args.device)
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_model(cfg, gen, device=dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    batch = make_batch(cfg, B, P, args.seed, 0, device=dev)

    out = generate(cfg, model, batch, G)
    print(f"prefill: {out.prefill_s:.2f}s")
    print(f"decode: {G-1} steps in {out.decode_s:.2f}s "
          f"({1000*out.decode_s/max(1, G-1):.1f} ms/token, batch {B})")
    print("generated (first row):", out.tokens[0].tolist())
    return out.tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
