"""The decode kernel walking a paged pool vs the dense XLA reference
(interpret mode on the CPU)."""
import numpy as np
import pytest

import jax.numpy as jnp

from gemma_tpu.models.config import GemmaConfig
from gemma_tpu.ops.attention import (
    paged_decode_attention,
    paged_decode_supported,
    sdpa_xla,
)
from gemma_tpu.runtime.paged_kv import PagedKVCache


def make_paged(rng, B, Hkv, D, n_pages, ps, maxp, lengths, layers=1):
    cfg = GemmaConfig(
        vocab_size=64, d_model=Hkv * D, n_layers=layers, n_heads=Hkv,
        n_kv_heads=Hkv, head_dim=D, d_ff=64, context_length=maxp * ps,
    )
    cache = PagedKVCache.create(
        cfg, B, n_pages, page_size=ps, max_seq_len=maxp * ps
    )
    # assign distinct physical pages per sequence, shuffled (page 0 = trash)
    perm = rng.permutation(n_pages - 1) + 1
    pt = np.zeros((B, maxp), np.int32)
    # dense mirrors use the cache-native [.., Hkv, S, D] layout
    k_dense = np.zeros((layers, B, Hkv, maxp * ps, D), np.float32)
    v_dense = np.zeros_like(k_dense)
    kp = np.zeros((layers, n_pages, Hkv, ps, D), np.float32)
    vp = np.zeros_like(kp)
    nxt = 0
    for b in range(B):
        n_live = -(-lengths[b] // ps)
        for i in range(n_live):
            pg = int(perm[nxt]); nxt += 1
            pt[b, i] = pg
            kc = rng.normal(size=(Hkv, ps, D)) * 0.3
            vc = rng.normal(size=(Hkv, ps, D)) * 0.3
            kp[:, pg], vp[:, pg] = kc, vc
            k_dense[:, b, :, i * ps : (i + 1) * ps] = kc
            v_dense[:, b, :, i * ps : (i + 1) * ps] = vc
    cache = PagedKVCache(
        k_pages=tuple(jnp.asarray(kp[l], jnp.bfloat16) for l in range(layers)),
        v_pages=tuple(jnp.asarray(vp[l], jnp.bfloat16) for l in range(layers)),
        page_table=jnp.asarray(pt),
        length=jnp.asarray(lengths, jnp.int32),
    )
    return cache, jnp.asarray(k_dense, jnp.bfloat16), jnp.asarray(v_dense, jnp.bfloat16)


CASES = [
    # B, Hq, Hkv, D, ps, maxp, n_pages, lengths, softcap, window
    (1, 4, 1, 128, 16, 4, 8, [40], 0.0, 0),
    (2, 8, 2, 128, 16, 8, 24, [17, 128], 0.0, 0),
    (1, 4, 4, 128, 16, 4, 8, [64], 30.0, 0),     # MHA G=1 (pad to 8) + softcap
    (2, 8, 8, 128, 16, 8, 24, [100, 33], 0.0, 32),  # sliding window
    (1, 2, 2, 256, 32, 4, 6, [96], 0.0, 0),      # D=256, ps=32
]


@pytest.mark.parametrize("B,Hq,Hkv,D,ps,maxp,n_pages,lengths,softcap,window", CASES)
def test_paged_matches_dense(B, Hq, Hkv, D, ps, maxp, n_pages, lengths,
                             softcap, window, rng, interpret_kernels):
    cache, k_dense, v_dense = make_paged(rng, B, Hkv, D, n_pages, ps, maxp, lengths)
    q = jnp.asarray(rng.normal(size=(B, 1, Hq, D)) * 0.3, jnp.bfloat16)
    assert paged_decode_supported(cache, q)
    kv_limit = jnp.asarray(lengths, jnp.int32)
    positions = (kv_limit - 1)[:, None]

    got = np.asarray(
        paged_decode_attention(q, cache, 0, kv_limit, softcap, window), np.float32
    )
    ref = np.asarray(
        sdpa_xla(q, k_dense[0], v_dense[0], positions, kv_limit, softcap, window),
        np.float32,
    )
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_paged_unsupported_gates(interpret_kernels):
    def cache_and_q(D=64, ps=16, T=1, quantized=False):
        cfg = GemmaConfig(
            vocab_size=64, d_model=2 * D, n_layers=1, n_heads=2, n_kv_heads=2,
            head_dim=D, d_ff=64, context_length=64,
        )
        cache = PagedKVCache.create(cfg, 1, 5, page_size=ps, max_seq_len=64,
                                    quantized=quantized)
        return cache, jnp.zeros((1, T, 2, D), jnp.bfloat16)

    assert paged_decode_supported(*cache_and_q())
    assert paged_decode_supported(*cache_and_q(quantized=True))  # int8 in place
    assert not paged_decode_supported(*cache_and_q(T=2))  # not decode
    assert not paged_decode_supported(*cache_and_q(D=48))  # head_dim not 2^n
    assert not paged_decode_supported(*cache_and_q(ps=8))  # page below 16 keys
    cache, q = cache_and_q()
    assert not paged_decode_supported(cache, q.astype(jnp.float32))


def test_paged_plain_without_kernels():
    """On the CPU without the interpret hook the paged cache densifies."""
    cfg = GemmaConfig(
        vocab_size=64, d_model=128, n_layers=1, n_heads=2, n_kv_heads=2,
        head_dim=64, d_ff=64, context_length=64,
    )
    cache = PagedKVCache.create(cfg, 1, 5, page_size=16, max_seq_len=64)
    assert not paged_decode_supported(cache, jnp.zeros((1, 1, 2, 64), jnp.bfloat16))


def quantize_rows(x):
    """Per-(head, position) symmetric int8 over D: x [.., D] f32."""
    amax = np.abs(x).max(axis=-1)
    scale = amax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale == 0, 1.0, scale), 0.0)
    q = np.round(x * inv[..., None]).astype(np.int8)
    return q, scale.astype(np.float32)


@pytest.mark.parametrize("B,lengths,softcap,window", [
    (1, [40], 0.0, 0),
    (2, [17, 128], 0.0, 0),
    (1, [100], 30.0, 32),
])
def test_paged_int8_matches_dense(B, lengths, softcap, window, rng, interpret_kernels):
    """int8 pages read in place by the kernel vs the dequantized XLA path."""
    Hq, Hkv, D, ps, maxp, n_pages = 8, 2, 128, 16, 8, 24
    cache, k_dense, v_dense = make_paged(rng, B, Hkv, D, n_pages, ps, maxp, lengths)
    kp = np.stack([np.asarray(p, np.float32) for p in cache.k_pages])
    vp = np.stack([np.asarray(p, np.float32) for p in cache.v_pages])
    qk, sk = quantize_rows(kp)
    qv, sv = quantize_rows(vp)
    qcache = PagedKVCache(
        k_pages=(jnp.asarray(qk[0]),), v_pages=(jnp.asarray(qv[0]),),
        page_table=cache.page_table, length=cache.length,
        k_scale=(jnp.asarray(sk[0]),), v_scale=(jnp.asarray(sv[0]),),
    )
    q = jnp.asarray(rng.normal(size=(B, 1, Hq, D)) * 0.3, jnp.bfloat16)
    assert qcache.quantized and paged_decode_supported(qcache, q)
    kv_limit = jnp.asarray(lengths, jnp.int32)
    positions = (kv_limit - 1)[:, None]

    got = np.asarray(
        paged_decode_attention(q, qcache, 0, kv_limit, softcap, window), np.float32
    )
    # reference: dequantize densely, then XLA attention
    kd = (qk[0][np.asarray(cache.page_table)] * sk[0][np.asarray(cache.page_table)][..., None])
    vd = (qv[0][np.asarray(cache.page_table)] * sv[0][np.asarray(cache.page_table)][..., None])
    # [B, maxp, H, ps, D] -> [B, H, maxp*ps, D]
    kd = kd.transpose(0, 2, 1, 3, 4).reshape(B, Hkv, maxp * ps, D)
    vd = vd.transpose(0, 2, 1, 3, 4).reshape(B, Hkv, maxp * ps, D)
    ref = np.asarray(
        sdpa_xla(q, jnp.asarray(kd, jnp.bfloat16), jnp.asarray(vd, jnp.bfloat16),
                 positions, kv_limit, softcap, window),
        np.float32,
    )
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)
