"""Attention: the prefill dispatch against an independent numpy attention,
and the split-K decode kernel (interpret mode on the CPU) against sdpa_xla.

The test_flash_* names are those of the prefill cases from when prefill
had a flash kernel of its own; they now check `prefill_attention` (cuDNN's
fused attention on the GPU, `sdpa_xla` elsewhere).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gemma_tpu.ops import _backend
from gemma_tpu.ops import attention as attn_mod
from gemma_tpu.ops.attention import (
    attention,
    decode_attention,
    decode_supported,
    prefill_attention,
    sdpa_xla,
)


def make_qkv(rng, B, T, S, Hq, Hkv, D):
    # k/v use the cache-native [B, Hkv, S, D] layout
    q = jnp.asarray(rng.normal(size=(B, T, Hq, D)) * 0.3, jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(B, Hkv, S, D)) * 0.3, jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(B, Hkv, S, D)) * 0.3, jnp.bfloat16)
    return q, k, v


def np_attention(q, k, v, positions, kv_limit, softcap=0.0, window=0):
    """Float64 reference, written from the masking rule alone: key j
    attends iff j <= pos, j < kv_limit and (window) j > pos - window. A row
    with no valid key returns zeros."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    positions, kv_limit = np.asarray(positions), np.asarray(kv_limit)
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = np.zeros_like(q)
    for b in range(B):
        for t in range(T):
            p = positions[b, t]
            j = np.arange(S)
            ok = (j <= p) & (j < kv_limit[b])
            if window:
                ok &= j > p - window
            if not ok.any():
                continue
            for h in range(Hq):
                kh = h // (Hq // Hkv)
                s = k[b, kh] @ q[b, t, h]
                if softcap:
                    s = softcap * np.tanh(s / softcap)
                s = np.where(ok, s, -np.inf)
                w = np.exp(s - s.max())
                out[b, t, h] = (w / w.sum()) @ v[b, kh]
    return out


def _check_prefill(q, k, v, positions, kv_limit, softcap=0.0, window=0):
    got = np.asarray(
        prefill_attention(q, k, v, positions, kv_limit, softcap, window), np.float32
    )
    ref = np_attention(q, k, v, positions, kv_limit, softcap, window)
    live = np.asarray(positions) < np.asarray(kv_limit)[:, None]  # rows with keys
    np.testing.assert_allclose(got[live], ref[live], atol=2e-2, rtol=2e-2)


PREFILL_CASES = [
    # B, T, S, Hq, Hkv, D, kv_limits, pos0
    (1, 16, 16, 4, 4, 32, [16], 0),          # MHA full square
    (1, 16, 32, 8, 2, 32, [25], 0),          # GQA, partial cache
    (2, 16, 32, 4, 1, 32, [16, 9], 0),       # MQA, per-batch limits
    (1, 32, 32, 2, 2, 32, [32], 0),          # longer causal square
    (1, 16, 48, 4, 4, 32, [48], 32),         # offset queries (chunked prefill)
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,limits,pos0", PREFILL_CASES)
def test_flash_matches_xla(B, T, S, Hq, Hkv, D, limits, pos0, rng):
    q, k, v = make_qkv(rng, B, T, S, Hq, Hkv, D)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32) + pos0, (B, T))
    _check_prefill(q, k, v, positions, jnp.asarray(limits, jnp.int32))


def test_flash_softcap(rng):
    q, k, v = make_qkv(rng, 1, 16, 16, 2, 2, 32)
    positions = jnp.arange(16, dtype=jnp.int32)[None]
    _check_prefill(q, k, v, positions, jnp.asarray([16], jnp.int32), softcap=30.0)


@pytest.mark.parametrize("window", [4, 10, 16])
def test_flash_sliding_window(window, rng):
    q, k, v = make_qkv(rng, 1, 16, 32, 4, 2, 32)
    positions = (jnp.arange(16, dtype=jnp.int32) + 16)[None]  # offset queries
    _check_prefill(q, k, v, positions, jnp.asarray([32], jnp.int32), window=window)


def test_flash_non_consecutive_positions(rng):
    """Arbitrary (shuffled, gapped) per-row query positions."""
    B, T, S, Hq, Hkv, D = 2, 16, 32, 4, 2, 32
    q, k, v = make_qkv(rng, B, T, S, Hq, Hkv, D)
    positions = jnp.asarray(
        np.stack(
            [
                rng.permutation(np.arange(0, 2 * T, 2))[:T],  # gapped + shuffled
                rng.integers(0, S, size=T),
            ]
        ),
        jnp.int32,
    )
    _check_prefill(q, k, v, positions, jnp.asarray([S, 22], jnp.int32))


def test_flash_rows_before_any_key(rng):
    """Query rows with no valid key (position past kv_limit handled, and
    rows before the first key) must not NaN."""
    q, k, v = make_qkv(rng, 1, 16, 16, 2, 2, 32)
    positions = jnp.arange(16, dtype=jnp.int32)[None] - 4  # rows 0..3 see nothing
    out = np.asarray(
        prefill_attention(q, k, v, positions, jnp.asarray([1], jnp.int32)), np.float32
    )
    assert np.isfinite(out).all()


DECODE_CASES = [
    # B, S, Hq, Hkv, D, limits, softcap, window
    (1, 512, 8, 1, 256, [200], 0.0, 0),        # Gemma-2B MQA
    (2, 256, 16, 16, 256, [77, 130], 0.0, 0),  # Gemma-7B MHA (G=1 padding)
    (1, 256, 8, 2, 128, [256], 30.0, 0),       # GQA + softcap
    (1, 512, 8, 1, 256, [300], 0.0, 64),       # sliding window
    (1, 512, 8, 1, 256, [1], 0.0, 0),          # single valid key
    # mostly-dead caches: only the live blocks are read, split across
    # programs; a window whose live span starts mid-cache
    (1, 2048, 4, 4, 64, [300], 0.0, 0),        # MHA, few live blocks of many
    (2, 2048, 8, 1, 128, [1100, 64], 0.0, 0),
    (1, 2048, 8, 1, 128, [1500], 0.0, 256),    # dead blocks both sides of window
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,win", DECODE_CASES)
def test_decode_kernel_matches_xla(B, S, Hq, Hkv, D, limits, cap, win, rng,
                                   interpret_kernels):
    q, k, v = make_qkv(rng, B, 1, S, Hq, Hkv, D)
    assert decode_supported(q, k)
    kv_limit = jnp.asarray(limits, jnp.int32)
    positions = (kv_limit - 1)[:, None]  # decode: query sits at limit-1
    got = np.asarray(
        decode_attention(q, k, v, kv_limit, attn_softcap=cap, window=win),
        np.float32,
    )
    ref = np.asarray(
        sdpa_xla(q, k, v, positions, kv_limit, attn_softcap=cap, window=win),
        np.float32,
    )
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def quant(x):
    amax = np.abs(x).max(axis=-1)
    scale = amax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale == 0, 1.0, scale), 0.0)
    return np.round(x * inv[..., None]).astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,win", DECODE_CASES)
def test_decode_kernel_int8_kv(B, S, Hq, Hkv, D, limits, cap, win, rng,
                               interpret_kernels):
    """int8 cache rows read in place (scales folded into the dots) vs the
    dequantize-then-XLA reference."""
    q, k, v = make_qkv(rng, B, 1, S, Hq, Hkv, D)
    qk, sk = quant(np.asarray(k, np.float32))
    qv, sv = quant(np.asarray(v, np.float32))
    kv_limit = jnp.asarray(limits, jnp.int32)
    positions = (kv_limit - 1)[:, None]
    got = np.asarray(
        decode_attention(
            q, jnp.asarray(qk), jnp.asarray(qv), kv_limit, attn_softcap=cap,
            window=win, k_scale=jnp.asarray(sk), v_scale=jnp.asarray(sv),
        ),
        np.float32,
    )
    kd = jnp.asarray(qk * sk[..., None], jnp.bfloat16)
    vd = jnp.asarray(qv * sv[..., None], jnp.bfloat16)
    ref = np.asarray(
        sdpa_xla(q, kd, vd, positions, kv_limit, attn_softcap=cap, window=win),
        np.float32,
    )
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("programs,max_blocks,want", [
    (1, 8, 8),       # Gemma-2B batch 1, 512-slot cache: one split per block
    (1, 64, 64),     # 4096 slots: capped by the blocks
    (16, 64, 16),    # Gemma-7B batch 1: 16 KV heads x 16 splits
    (300, 64, 1),    # enough (sequence, head) programs already
])
def test_tile_policies(programs, max_blocks, want):
    """The decode kernel splits the live range until about two programs
    per SM exist, never into more splits than the cache has blocks."""
    assert attn_mod._split_count(programs, max_blocks) == want


def test_dispatch(rng, interpret_kernels):
    """attention() sends T=1 bf16 to the decode kernel and everything else
    (T>1, f32 queries, odd head_dim, plain_path) to prefill_attention,
    which on the CPU is sdpa_xla."""
    calls = []
    real = attn_mod.decode_attention
    attn_mod.decode_attention = lambda *a, **k: calls.append("kernel") or real(*a, **k)
    try:
        q, k, v = make_qkv(rng, 1, 1, 128, 4, 2, 32)
        lim = jnp.asarray([50], jnp.int32)
        pos = (lim - 1)[:, None]
        attention(q, k, v, pos, lim)
        assert calls == ["kernel"]
        attention(q.astype(jnp.float32), k, v, pos, lim)
        q3, k3, v3 = make_qkv(rng, 1, 1, 128, 4, 2, 48)  # head_dim not 2^n
        attention(q3, k3, v3, pos, lim)
        qp, _, _ = make_qkv(rng, 1, 4, 128, 4, 2, 32)
        attention(qp, k, v, jnp.arange(4, dtype=jnp.int32)[None], lim)
        with _backend.plain_path():
            attention(q, k, v, pos, lim)
        assert calls == ["kernel"]
    finally:
        attn_mod.decode_attention = real
