"""Port parity: whole models of the attention family (dense, MoE, VLM) on
the JAX package's weights, carried by `interop.lm_params`.

For each reduced configuration (float32, two repeats of the block
pattern): `forward` logits and aux, `prefill` logits and caches, and three
`decode_step`s with their logits and caches, against the JAX package on
the same weights and batch; each decode step starts from the JAX state
(`torch_lm.port_cache`), under float32 and under the default bf16
caches. Bound: ``max|port - JAX| <= 1e-4 · max|JAX logits|``
(``LOGITS_REL``); decode logits over bf16 caches ``2**-8 · max|JAX
logits|`` (a key or value written in the step may round to the other
bf16 neighbour: one ulp); bf16 cache leaves within one bf16 ulp, float32
leaves within ``1e-4 · max|leaf|``. The recurrent and
encoder-decoder families and the launcher's greedy loop are in
`test_torch_lm_recurrent.py`.
"""
import pytest

from torch_lm import check_init_cache, check_layers, check_model

ARCHS = ("qwen2-1.5b", "glm4-9b", "smollm-360m", "minitron-8b",
         "qwen2-vl-72b", "granite-moe-3b-a800m", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode(arch):
    check_model(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_on_jax_inputs(arch):
    check_layers(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_first_decode(arch):
    check_init_cache(arch)
