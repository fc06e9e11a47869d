"""Port parity: the LM stack's layers against the JAX package's, on the
same numpy inputs and parameters (float32, CPU).

Bound: ``rtol=1e-5, atol=1e-6`` (`np.testing.assert_allclose`) unless a
test states another; the recurrences, whose outputs pass through a
normalization or an exponential, are held to ``1e-5 · max|JAX|``.
`_alto_sort_dispatch`'s ``order``, ``slot`` and ``seg_expert`` are equal
bit for bit, and both raise the same `ValueError` past 32 key bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import rope as jrope
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.models import rope as trope
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from torch_lm import (assert_close_to_max, jax_params, np_of, perturb,
                      to_torch)

RTOL, ATOL = 1e-5, 1e-6
REL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def _cfgs(arch, **over):
    return (dataclasses.replace(jreduced(arch), **over),
            dataclasses.replace(treduced(arch), **over))


def _params(defs, seed, rng):
    tree = perturb(jax_params(defs, seed), rng)
    return jax.tree.map(jnp.asarray, tree), to_torch(tree)


def _x(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, 2, 5, 16)
    js, ts = _x(rng, 16)
    jb, tb = _x(rng, 16)
    _close(tcommon.rmsnorm({"scale": ts}, tx, 1e-5),
           jcommon.rmsnorm({"scale": js}, jx, 1e-5))
    _close(tcommon.layernorm({"scale": ts, "bias": tb}, tx),
           jcommon.layernorm({"scale": js, "bias": jb}, jx))


def test_apply_rope():
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, 2, 6, 3, 8)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    _close(trope.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jrope.apply_rope(jx, jnp.asarray(pos), 1e4), rtol=1e-5,
           atol=1e-5)


def test_apply_mrope():
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, 2, 6, 3, 8)
    pos3 = rng.integers(0, 300, (3, 2, 6)).astype(np.int32)
    _close(trope.apply_mrope(tx, torch.from_numpy(pos3), 1e6, (1, 1, 2)),
           jrope.apply_mrope(jx, jnp.asarray(pos3), 1e6, (1, 1, 2)),
           rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        trope.apply_mrope(tx, torch.from_numpy(pos3), 1e6, (1, 1, 1))


@pytest.mark.parametrize("arch,S,chunk,causal,cross", [
    ("qwen2-1.5b", 16, 4, True, False),      # chunked, GQA, QKV bias
    ("qwen2-1.5b", 16, 64, True, False),     # one chunk
    ("qwen2-1.5b", 12, 8, True, False),      # 8 does not divide 12: C = S
    ("smollm-360m", 16, 4, False, False),    # full (encoder) attention
    ("whisper-base", 10, 4, False, True),    # cross over 24 encoder frames
    ("qwen2-vl-72b", 16, 4, True, False),    # M-RoPE positions
])
def test_attention_full(arch, S, chunk, causal, cross):
    cj, ct = _cfgs(arch, attn_chunk=chunk)
    rng = np.random.default_rng(3)
    jp, tp = _params(jattn.attn_def(cj), 1, rng)
    jx, tx = _x(rng, 2, S, cj.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    kw_j, kw_t = {}, {}
    if cross:
        jk, tk = _x(rng, 2, cj.encoder_seq, cj.d_model)
        kw_j["kv_x"], kw_t["kv_x"] = jk, tk
    if cj.mrope:
        p3 = rng.integers(0, 40, (3, 2, S)).astype(np.int32)
        kw_j["positions3"] = jnp.asarray(p3)
        kw_t["positions3"] = torch.from_numpy(p3)
    want, (wk, wv) = jax.jit(lambda p, x, kw: jattn.attention_full(
        cj, p, x, jnp.asarray(pos), causal=causal, return_kv=True, **kw))(
        jp, jx, kw_j)
    got, (gk, gv) = tattn.attention_full(ct, tp, tx, torch.from_numpy(pos),
                                         causal=causal, return_kv=True,
                                         **kw_t)
    assert_close_to_max(got, want, REL)
    assert_close_to_max(gk, wk, REL)
    assert_close_to_max(gv, wv, REL)


@pytest.mark.parametrize("arch,cache_dtype,cross", [
    ("qwen2-1.5b", "float32", False), ("qwen2-1.5b", "bfloat16", False),
    ("whisper-base", "float32", False), ("whisper-base", "float32", True),
    ("qwen2-vl-72b", "float32", False)])
def test_attention_decode(arch, cache_dtype, cross):
    cj, ct = _cfgs(arch)
    rng = np.random.default_rng(4)
    jp, tp = _params(jattn.attn_def(cj), 2, rng)
    jx, tx = _x(rng, 2, 1, cj.d_model)
    shape = (2, 12, cj.n_kv_heads, cj.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    jdt = getattr(jnp, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    jc = jattn.KVCache(jnp.asarray(kc, jdt), jnp.asarray(vc, jdt))
    tc = tattn.KVCache(torch.from_numpy(kc).to(tdt),
                       torch.from_numpy(vc).to(tdt))
    want, wc = jax.jit(lambda p, x, c: jattn.attention_decode(
        cj, p, x, c, 7, cross=cross))(jp, jx, jc)
    got, gc = tattn.attention_decode(ct, tp, tx, tc, 7, cross=cross)
    assert_close_to_max(got, want, REL)
    assert gc.k.dtype == tdt
    _close(gc.k, wc.k, atol=1e-5)
    _close(gc.v, wc.v, atol=1e-5)


def test_mlp():
    cj, ct = _cfgs("smollm-360m")
    rng = np.random.default_rng(5)
    jp, tp = _params(jmlp.mlp_def(cj), 3, rng)
    jx, tx = _x(rng, 2, 7, cj.d_model)
    _close(tmlp.mlp(tp, tx), jax.jit(jmlp.mlp)(jp, jx), atol=1e-5)


def _ssd_inputs(rng, S, H, G, N=8, P=16):
    a = (-np.abs(rng.standard_normal((2, S, H))) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    X = rng.standard_normal((2, S, H, P)).astype(np.float32)
    Cm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    return a, Bm, X, Cm


@pytest.mark.parametrize("S,chunk,G", [(32, 8, 1), (32, 8, 4), (12, 5, 1),
                                       (16, 32, 4), (7, 4, 2)])
def test_ssd_chunked(S, chunk, G):
    """Chunks of 8; 5 does not divide 12 (Q falls to 4), 4 not 7 (Q 1)."""
    arrs = _ssd_inputs(np.random.default_rng(S + chunk + G), S, 4, G)
    wy, wh = jax.jit(jssm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, arrs), chunk)
    gy, gh = tssm.ssd_chunked(*map(torch.from_numpy, arrs), chunk)
    assert_close_to_max(gy, wy, REL)
    assert_close_to_max(gh, wh, REL)


def test_ssd_step():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((2, 4)))).astype(np.float32)
    Bm = rng.standard_normal((2, 2, 8)).astype(np.float32)
    X = rng.standard_normal((2, 4, 16)).astype(np.float32)
    Cm = rng.standard_normal((2, 2, 8)).astype(np.float32)
    wy, wh = jax.jit(jssm.ssd_step)(*map(jnp.asarray, (h, a, Bm, X, Cm)))
    gy, gh = tssm.ssd_step(*map(torch.from_numpy, (h, a, Bm, X, Cm)))
    _close(gy, wy, atol=1e-5)
    _close(gh, wh, atol=1e-5)


def test_softplus_has_no_threshold():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.9, 20.0, 20.5, 40.0, 90.0],
                 np.float32)
    _close(tssm.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)))


RECURRENT = {
    "mamba": ("zamba2-7b", jssm.mamba_def, jssm.mamba_apply,
              jssm.mamba_decode, tssm.mamba_apply, tssm.mamba_decode),
    "mlstm": ("xlstm-1.3b", jxlstm.mlstm_def, jxlstm.mlstm_apply,
              jxlstm.mlstm_decode, txlstm.mlstm_apply, txlstm.mlstm_decode),
    "slstm": ("xlstm-1.3b", jxlstm.slstm_def, jxlstm.slstm_apply,
              jxlstm.slstm_decode, txlstm.slstm_apply, txlstm.slstm_decode),
}


@pytest.mark.parametrize("kind", list(RECURRENT))
@pytest.mark.parametrize("S", [16, 12])
def test_recurrent_apply_and_decode(kind, S):
    """apply with its cache (chunk 8: 12 falls to chunks of 6), then two
    decode steps from that cache."""
    arch, jdef, japply, jdecode, tapply, tdecode = RECURRENT[kind]
    cj, ct = _cfgs(arch)
    rng = np.random.default_rng(7)
    jp, tp = _params(jdef(cj), 4, rng)
    jx, tx = _x(rng, 2, S, cj.d_model)
    wy, wc = jax.jit(lambda p, x: japply(cj, p, x, return_cache=True))(
        jp, jx)
    jdec = jax.jit(lambda p, x, c: jdecode(cj, p, x, c))
    gy, gc = tapply(ct, tp, tx, return_cache=True)
    assert_close_to_max(gy, wy, REL)
    for w, g in zip(wc, gc):
        assert g.dtype == {jnp.dtype("float32"): torch.float32,
                           jnp.dtype("bfloat16"): torch.bfloat16}[w.dtype]
        assert_close_to_max(g, w, REL if w.dtype == jnp.float32 else 1e-2)
    for step in range(2):
        jx1, tx1 = _x(rng, 2, 1, cj.d_model)
        wy, wc = jdec(jp, jx1, wc)
        gy, gc = tdecode(ct, tp, tx1, gc)
        assert_close_to_max(gy, wy, REL)
        for w, g in zip(wc, gc):
            assert_close_to_max(g, w, REL if w.dtype == jnp.float32
                                else 1e-2)


@pytest.mark.parametrize("alto", [True, False])
@pytest.mark.parametrize("cf,S", [(1.25, 16), (0.25, 32), (1.25, 1)])
def test_moe_ffn(alto, cf, S):
    """Both dispatches; capacity 0.25 drops pairs, S = 1 is a decode."""
    cj, ct = _cfgs("granite-moe-3b-a800m", moe_alto_dispatch=alto,
                   capacity_factor=cf)
    rng = np.random.default_rng(8)
    jp, tp = _params(jmoe.moe_def(cj), 5, rng)
    jx, tx = _x(rng, 3, S, cj.d_model)
    wy, waux = jax.jit(lambda p, x: jmoe.moe_ffn(cj, p, x))(jp, jx)
    gy, gaux = tmoe.moe_ffn(ct, tp, tx)
    assert_close_to_max(gy, wy, REL)
    _close(gaux, waux)
    if cf < 1:
        top_e = torch.topk(torch.softmax(torch.einsum(
            "bsd,de->bse", tx, tp["router"]), -1), ct.experts_per_token,
            dim=-1).indices
        _, keep, _ = tmoe.dispatch_slots(ct, top_e,
                                         tmoe._capacity(ct, S), alto)
        assert not bool(keep.all())        # the drop path ran


@pytest.mark.parametrize("n,E,seed", [(1, 8, 0), (64, 8, 1), (200, 40, 2),
                                      (1000, 384, 3), (8, 2**29, 4)])
def test_alto_sort_dispatch_bitwise(n, E, seed):
    """Up to the 32-bit limit (8 pairs under 2**29 experts: 32 bits)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, E, n).astype(np.int32)
    if n > 1:
        e[: n // 3] = e[0]                   # long runs of one expert
    want = jax.jit(jmoe._alto_sort_dispatch, static_argnums=(1, 2))(
        jnp.asarray(e), E, n)
    got = tmoe._alto_sort_dispatch(torch.from_numpy(e), E, n)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_alto_sort_dispatch_rows_and_slots():
    """A batch of rows sorts row by row (each row equals its 1-D call), and
    the ALTO slots and keeps equal the reference dispatch's."""
    rng = np.random.default_rng(9)
    e = torch.from_numpy(rng.integers(0, 8, (3, 40)))
    rows = tmoe._alto_sort_dispatch(e, 8, 20)
    for b in range(3):
        for r, s in zip(rows, tmoe._alto_sort_dispatch(e[b], 8, 20)):
            assert torch.equal(r[b], s)
    ct = treduced("granite-moe-3b-a800m")
    top_e = torch.stack([torch.randperm(8, generator=torch.Generator()
                                        .manual_seed(i))[:2]
                         for i in range(60)]).view(3, 20, 2)
    a = tmoe.dispatch_slots(ct, top_e, 8, True)
    r = tmoe.dispatch_slots(ct, top_e, 8, False)
    assert torch.equal(a[0], r[0]) and torch.equal(a[1], r[1])


@pytest.mark.parametrize("n,E", [(8, 2**30), (2**3 + 1, 2**29)])
def test_alto_sort_dispatch_refuses_past_32_bits(n, E):
    e = np.zeros(n, np.int32)
    with pytest.raises(ValueError) as want:
        jmoe._alto_sort_dispatch(jnp.asarray(e), E, n)
    with pytest.raises(ValueError) as got:
        tmoe._alto_sort_dispatch(torch.from_numpy(e), E, n)
    assert str(got.value) == str(want.value)
