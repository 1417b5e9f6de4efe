"""Attention: plain prefill dispatch and a split-K decode kernel (Triton).

Replaces the reference's materialized QK^T + dense 512x512 -inf mask + full
softmax (`/root/reference/src/gemma_model.cpp:326-335,454-496`).

Shapes (cache-native, GQA-general):
    q:  [B, T, Hq, D]    (already scaled by query_scale, RoPE applied)
    k,v:[B, Hkv, S, D]   (the dense KV-cache's own layout), or the paged
                         pool [P, Hkv, ps, D] with a block table
    positions: [B, T]    absolute query positions (mask: key_idx <= pos)
    kv_limit:  [B]       number of valid cache slots

Masking rule matches runtime.kv_cache semantics: key slot j attends iff
j <= position[q] and j < kv_limit[b] (and j > position[q] - window when a
sliding window is set).

* Prefill (T > 1) is compute-bound and needs no kernel of its own: on the
  GPU it runs cuDNN's fused flash attention through
  `jax.nn.dot_product_attention` with the mask above; layers with a logit
  softcap (Gemma-2), which cuDNN does not cover, and every other backend run
  `sdpa_xla`.
* Decode (T = 1) reads the cache once per step, so its cost is bytes. The
  kernel splits the LIVE key range of each (sequence, KV head) across
  programs that run in parallel; each program loops over its blocks with an
  online softmax and writes a partial (m, l, acc), which a small XLA merge
  combines. Blocks past `kv_limit` or before the window are never read, so
  a step costs the live prefix, not the allocation. int8 caches are read
  in place: the per-position scales commute through both dots, s = (q·k8)
  * ks and out = (p * vs) @ v8. The same kernel walks a paged pool, each
  block loading its own page index from the block table.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import _backend

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)
DECODE_BLOCK = 64  # keys per inner-loop block of the dense decode kernel
_MIN_G = 16  # pl.dot's least row count: query heads per KV head pad to this
_TARGET_PROGRAMS = 264  # two programs per SM of an H100
# cuDNN's fused attention beats sdpa_xla from about this many scores
# (Hq * T * S) up; below it XLA's fusions are faster (PERF.md)
CUDNN_MIN_SCORES = 1 << 24
_NUM_WARPS = 4
_NUM_STAGES = 2


def _valid(positions, kv_limit, S: int, window: int) -> jax.Array:
    """[B, T, S] mask of the keys each query attends to."""
    key_idx = jnp.arange(S, dtype=jnp.int32)
    valid = (key_idx[None, None, :] <= positions[:, :, None]) & (
        key_idx[None, None, :] < kv_limit[:, None, None]
    )
    if window > 0:  # sliding window: only the last `window` positions
        valid &= key_idx[None, None, :] > positions[:, :, None] - window
    return valid


def sdpa_xla(
    q: jax.Array,  # [B, T, Hq, D] (scaled)
    k: jax.Array,  # [B, Hkv, S, D]
    v: jax.Array,  # [B, Hkv, S, D]
    positions: jax.Array,  # [B, T]
    kv_limit: jax.Array,  # [B]
    attn_softcap: float = 0.0,
    window: int = 0,
) -> jax.Array:
    """The plain attention every path is checked against."""
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scores = jnp.einsum("bthgd,bhsd->bhgts", qg, k, preferred_element_type=jnp.float32)
    if attn_softcap:
        scores = attn_softcap * jnp.tanh(scores / attn_softcap)
    valid = _valid(positions, kv_limit, S, window)
    scores = jnp.where(valid[:, None, None], scores, -1e30)
    w = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bhgts,bhsd->bthgd", w.astype(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def prefill_attention(
    q, k, v, positions, kv_limit, attn_softcap: float = 0.0, window: int = 0
) -> jax.Array:
    """T > 1: cuDNN flash attention on the GPU where it covers the layer and
    the layer is large enough to gain, `sdpa_xla` otherwise."""
    _, T, Hq, D = q.shape
    cudnn = (
        _backend.use_kernels("attention")
        and _backend.on_gpu()
        and Hq * T * k.shape[2] >= CUDNN_MIN_SCORES
        and not attn_softcap
        and q.dtype == k.dtype == jnp.bfloat16
        and D % 8 == 0
        and D <= 256
    )
    if not cudnn:
        return sdpa_xla(q, k, v, positions, kv_limit, attn_softcap, window)
    mask = _valid(positions, kv_limit, k.shape[2], window)[:, None]
    return jax.nn.dot_product_attention(
        q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
        mask=mask, scale=1.0, implementation="cudnn",
    )


# ---------------------------------------------------------------------------
# Split-K decode kernel
# ---------------------------------------------------------------------------

def _decode_kernel(*refs, bs, splits, window, attn_softcap, paged, quantized):
    if quantized:
        q_ref, k_ref, v_ref, ks_ref, vs_ref, *refs = refs
    else:
        q_ref, k_ref, v_ref, *refs = refs
    if paged:
        pt_ref, lim_ref, o_ref, m_ref, l_ref = refs
    else:
        lim_ref, o_ref, m_ref, l_ref = refs
    b, h, s = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    limit = lim_ref[b]
    lo = jnp.maximum(limit - window, 0) if window > 0 else 0
    first = lo // bs
    n_live = (limit + bs - 1) // bs - first
    per = (n_live + splits - 1) // splits
    start = first + s * per
    end = jnp.minimum(start + per, first + n_live)

    q = q_ref[b, h]  # [Gp, D] bf16
    Gp, D = q.shape

    def block(j):
        if paged:
            page = pt_ref[b, j]
            return page, h, slice(None)
        return b, h, pl.ds(j * bs, bs)

    def body(j, carry):
        acc, m, l = carry
        i0, i1, i2 = block(j)
        k = k_ref[i0, i1, i2, :]  # [bs, D]
        sc = pl.dot(q, k.astype(jnp.bfloat16), trans_b=True)  # [Gp, bs] f32
        if quantized:
            sc = sc * ks_ref[i0, i1, i2][None, :]
        if attn_softcap:
            sc = attn_softcap * jnp.tanh(sc / attn_softcap)
        col = j * bs + jax.lax.broadcasted_iota(jnp.int32, (Gp, bs), 1)
        valid = (col < limit) & (col >= lo)
        sc = jnp.where(valid, sc, MASK_VALUE)
        m_next = jnp.maximum(m, sc.max(axis=1))
        alpha = jnp.exp(m - m_next)
        p = jnp.where(valid, jnp.exp(sc - m_next[:, None]), 0.0)
        l = alpha * l + p.sum(axis=1)
        if quantized:
            p = p * vs_ref[i0, i1, i2][None, :]
        v = v_ref[i0, i1, i2, :].astype(jnp.bfloat16)
        acc = alpha[:, None] * acc + pl.dot(p.astype(jnp.bfloat16), v)
        return acc, m_next, l

    acc, m, l = jax.lax.fori_loop(
        start, end, body,
        (
            jnp.zeros((Gp, D), jnp.float32),
            jnp.full((Gp,), MASK_VALUE, jnp.float32),
            jnp.zeros((Gp,), jnp.float32),
        ),
    )
    o_ref[b, h, s] = acc
    m_ref[b, h, s] = m
    l_ref[b, h, s] = l


def _split_count(programs: int, max_blocks: int) -> int:
    """Splits of each live key range: the largest power of two that keeps
    the program count near _TARGET_PROGRAMS, at most one per cache block."""
    s = 1
    while programs * s * 2 <= _TARGET_PROGRAMS and s * 2 <= max_blocks:
        s *= 2
    return s


@functools.partial(
    jax.jit,
    static_argnames=("bs", "window", "attn_softcap", "interpret"),
)
def _decode_call(
    qg, k, v, k_scale, v_scale, page_table, kv_limit,
    bs, window, attn_softcap, interpret,
):
    """qg [B, Hkv, Gp, D] -> (acc [B, Hkv, n, Gp, D], m, l [B, Hkv, n, Gp])
    over n splits of the live key range."""
    B, Hkv, Gp, D = qg.shape
    paged = page_table is not None
    quantized = k_scale is not None
    max_blocks = page_table.shape[1] if paged else k.shape[2] // bs
    splits = _split_count(B * Hkv, max_blocks)
    kernel = functools.partial(
        _decode_kernel, bs=bs, splits=splits, window=window,
        attn_softcap=attn_softcap, paged=paged, quantized=quantized,
    )
    inputs = [qg, k, v]
    if quantized:
        inputs += [k_scale, v_scale]
    if paged:
        inputs.append(page_table)
    inputs.append(kv_limit)
    return pl.pallas_call(
        kernel,
        grid=(B, Hkv, splits),
        out_shape=[
            jax.ShapeDtypeStruct((B, Hkv, splits, Gp, D), jnp.float32),
            jax.ShapeDtypeStruct((B, Hkv, splits, Gp), jnp.float32),
            jax.ShapeDtypeStruct((B, Hkv, splits, Gp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="decode_attention",
    )(*inputs)


def _run_decode(q, k, v, k_scale, v_scale, page_table, kv_limit, bs,
                attn_softcap, window):
    """Shared wrapper: pad query groups, run the kernel, merge the splits."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    Gp = max(_MIN_G, 1 << (G - 1).bit_length())
    qg = q.reshape(B, Hkv, G, D).astype(jnp.bfloat16)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, Gp - G), (0, 0)))
    acc, m, l = _decode_call(
        qg, k, v, k_scale, v_scale, page_table, kv_limit.astype(jnp.int32),
        bs, int(window), float(attn_softcap), _backend.interpret(),
    )
    m_all = m.max(axis=2, keepdims=True)
    w = jnp.exp(m - m_all)  # splits that saw no key carry m = MASK_VALUE
    out = (acc * w[..., None]).sum(axis=2) / (l * w).sum(axis=2)[..., None]
    return out[:, :, :G].reshape(B, 1, Hq, D).astype(q.dtype)


def decode_attention(
    q: jax.Array,  # [B, 1, Hq, D] scaled
    k: jax.Array,  # [B, Hkv, S, D] (cache layout; int8 when quantized)
    v: jax.Array,
    kv_limit: jax.Array,  # [B]; the query is at position kv_limit-1
    attn_softcap: float = 0.0,
    window: int = 0,
    k_scale: jax.Array | None = None,  # [B, Hkv, S] f32 (int8 mode)
    v_scale: jax.Array | None = None,
) -> jax.Array:
    """Decode attention over the dense cache through the kernel."""
    return _run_decode(
        q, k, v, k_scale, v_scale, None, kv_limit, DECODE_BLOCK,
        attn_softcap, window,
    )


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def decode_supported(q, k) -> bool:
    """Kernel path gate for T=1: power-of-two head_dim (a Triton block
    rule), whole key blocks, bf16 queries over a bf16 or int8 cache."""
    _, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    return (
        T == 1
        and _pow2(D)
        and S % DECODE_BLOCK == 0
        and Hq % Hkv == 0
        and q.dtype == jnp.bfloat16
        and k.dtype in (jnp.bfloat16, jnp.int8)
    )


def paged_decode_supported(cache, q) -> bool:
    """Kernel path gate for decode over a paged pool: as decode_supported,
    with a power-of-two page size of at least 16 keys."""
    Hkv, ps, D = cache.k_pages[0].shape[1:]
    _, T, Hq, _ = q.shape
    return (
        _backend.use_kernels("attention")
        and T == 1
        and _pow2(D)
        and _pow2(ps)
        and ps >= 16
        and Hq % Hkv == 0
        and q.dtype == jnp.bfloat16
        and cache.k_pages[0].dtype in (jnp.bfloat16, jnp.int8)
    )


def paged_decode_attention(
    q: jax.Array,  # [B, 1, Hq, D] scaled
    cache,  # PagedKVCache
    layer: int,
    kv_limit: jax.Array,  # [B]
    attn_softcap: float = 0.0,
    window: int = 0,
) -> jax.Array:
    """Decode attention over the paged pool, read through the block table
    by the same kernel; returns [B, 1, Hq, D]. Never densifies the pool."""
    quantized = cache.quantized
    return _run_decode(
        q, cache.k_pages[layer], cache.v_pages[layer],
        cache.k_scale[layer] if quantized else None,
        cache.v_scale[layer] if quantized else None,
        cache.page_table.astype(jnp.int32), kv_limit, cache.page_size,
        attn_softcap, window,
    )


def attention(
    q: jax.Array,  # [B, T, Hq, D] scaled
    k: jax.Array,  # [B, Hkv, S, D] (cache layout; int8 when scales given)
    v: jax.Array,
    positions: jax.Array,
    kv_limit: jax.Array,
    attn_softcap: float = 0.0,
    window: int = 0,
    k_scale: jax.Array | None = None,  # [B, Hkv, S] int8-KV scales
    v_scale: jax.Array | None = None,
) -> jax.Array:
    """Dispatch: the decode kernel for T=1 where kernels run and the shape
    fits, `prefill_attention` otherwise.

    With `k_scale`/`v_scale`, k/v are int8 and the decode kernel reads them
    in place; every other path dequantizes once first."""
    if _backend.use_kernels("attention") and decode_supported(q, k):
        return decode_attention(
            q, k, v, kv_limit, attn_softcap, window,
            k_scale=k_scale, v_scale=v_scale,
        )
    if k_scale is not None:  # dequantize once
        k = k.astype(jnp.bfloat16) * k_scale[..., None].astype(jnp.bfloat16)
        v = v.astype(jnp.bfloat16) * v_scale[..., None].astype(jnp.bfloat16)
    return prefill_attention(q, k, v, positions, kv_limit, attn_softcap, window)
