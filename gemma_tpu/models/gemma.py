"""Functional Gemma decoder forward pass (pure JAX).

Re-implements the math of the reference's per-token graph builder
(`/root/reference/src/gemma_model.cpp:665-747` and helpers, see SURVEY.md
§3.3) as a single traced function: embed·√d → N × [RMSNorm → QKV → NEOX RoPE
→ cached attention → out-proj → residual → RMSNorm → GeGLU FFN → residual]
→ final RMSNorm → tied-embedding logits. Where the reference rebuilds a ggml
cgraph every token in a scratch arena (`reset_compute_context`,
gemma_model.cpp:650-663), this function is traced once per shape bucket and
compiled by XLA.

Conventions (matching llama.cpp GGUF exports):
* weight matrices are [out_features, in_features]; projections are x @ W.T;
* RMSNorm weights arrive with the Gemma "+1" already baked in by the GGUF
  converter, so the graph computes rms(x) * w (like graph_build_norm,
  gemma_model.cpp:438-442);
* RoPE is NEOX-style (rotate halves), matching the reference's
  rope_custom mode 2 with freq_base from config (macro.h:12-18);
* GQA is general: n_kv_heads may be 1 (Gemma-2B MQA) .. n_heads (7B MHA) —
  the reference hardcodes MQA (SURVEY.md quirks).

Attention runs through gemma_tpu.ops.attention: cuDNN flash attention for
prefill and a Pallas decode kernel on the GPU, plain XLA elsewhere.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..ops.attention import attention, paged_decode_attention, paged_decode_supported
from ..ops.linear import linear
from ..runtime.kv_cache import KVCache
from ..utils.tensor_dump import record
from .config import GemmaConfig

Params = dict[str, Any]


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    normed = xf * jax.lax.rsqrt(var + eps)
    return (normed * w.astype(jnp.float32)).astype(x.dtype)


def apply_rope(
    x: jax.Array, positions: jax.Array, base: float, pos_scale: float = 1.0
) -> jax.Array:
    """NEOX rotary embedding. x: [B, T, H, D]; positions: [B, T] int32.
    `pos_scale` is linear rope scaling (Gemma-3 global layers)."""
    half = x.shape[-1] // 2
    freqs = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    theta = (positions.astype(jnp.float32) * pos_scale)[:, :, None, None] * freqs
    cos, sin = jnp.cos(theta), jnp.sin(theta)
    xf = x.astype(jnp.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    return out.astype(x.dtype)


def decoder_layer(
    lp: Params,
    cfg: GemmaConfig,
    x: jax.Array,  # [B, T, d_model]
    positions: jax.Array,  # [B, T]
    cache: KVCache,
    layer_idx: int,
    write_index: jax.Array,  # scalar (chunk start) or [B] (per-seq token slot)
    kv_limit: jax.Array,  # [B] valid cache slots after this write
    tp_axis: str | None = None,  # shard_map TP: psum partial projections
) -> tuple[jax.Array, KVCache]:
    """One decoder block. When `tp_axis` is set the caller runs this inside
    shard_map with Megatron-sharded weights (q/k/v & gate/up row-sharded,
    attn_output & ffn_down col-sharded): cfg must describe the LOCAL
    geometry (n_heads/d_ff divided by the axis size) and the two output
    projections produce partial sums that are psum'd here explicitly —
    the hand-written analogue of the collectives GSPMD inserts, keeping
    the kernels on shard-local weights (no all-gather of weights).
    """
    B, T, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    if "attn_qkv" in lp:  # fused projection (params.py _maybe_fuse)
        qkv = linear(h, lp["attn_qkv"])
        q, k, v = jnp.split(qkv, [cfg.q_dim, cfg.q_dim + cfg.kv_dim], axis=-1)
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    else:
        q = linear(h, lp["attn_q"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = linear(h, lp["attn_k"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = linear(h, lp["attn_v"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)

    if "attn_q_norm" in lp:  # Gemma-3 per-head QK-norm (before RoPE)
        q = rms_norm(q, lp["attn_q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["attn_k_norm"], cfg.rms_eps)
    rope_base, rope_pos_scale = cfg.layer_rope(layer_idx)
    q = apply_rope(q, positions, rope_base, rope_pos_scale) * jnp.asarray(
        cfg.effective_query_scale, dtype=x.dtype
    )
    k = apply_rope(k, positions, rope_base, rope_pos_scale)

    if write_index.ndim == 0:
        cache = cache.write_chunk(layer_idx, write_index, k, v)
    elif T == 1:
        cache = cache.write_token(layer_idx, write_index, k, v)
    else:
        # per-seq chunk starts (batched speculative verification). Paged
        # caches have no per-seq chunk write; fail loudly rather than
        # silently dropping rows (write_token keeps only t=0).
        cache = cache.write_chunk_per_seq(layer_idx, write_index, k, v)

    window = cfg.layer_window(layer_idx)
    if hasattr(cache, "page_table") and paged_decode_supported(cache, q):
        # paged pool read via block-table indirection — never densified
        attn = paged_decode_attention(
            q, cache, layer_idx, kv_limit, cfg.attn_softcap, window
        )
    elif getattr(cache, "quantized", False) and not hasattr(cache, "page_table"):
        # int8 cache: hand raw pages + scales to the attention dispatch so
        # the decode kernel reads int8 in place (no dequantized HBM copy)
        attn = attention(
            q, cache.k[layer_idx], cache.v[layer_idx], positions, kv_limit,
            cfg.attn_softcap, window=window,
            k_scale=cache.k_scale[layer_idx], v_scale=cache.v_scale[layer_idx],
        )
    else:
        kc, vc = cache.gather_layer(layer_idx)
        attn = attention(
            q, kc, vc, positions, kv_limit, cfg.attn_softcap, window=window
        )
    attn_out = linear(attn.reshape(B, T, cfg.q_dim), lp["attn_output"])
    if tp_axis is not None:  # col-sharded attn_output -> partial sums
        attn_out = jax.lax.psum(attn_out, tp_axis)
    if "post_attention_norm" in lp:  # Gemma-2/3 sandwich norm
        attn_out = rms_norm(attn_out, lp["post_attention_norm"], cfg.rms_eps)
    x = x + attn_out
    record(f"blk.{layer_idx}.attn_out", x)

    h2 = rms_norm(x, lp["ffn_norm"], cfg.rms_eps)
    if "ffn_gate_up" in lp:
        gu = linear(h2, lp["ffn_gate_up"]).astype(jnp.float32)
        gate_v, up = gu[..., : cfg.d_ff], gu[..., cfg.d_ff :]
        gate = jax.nn.gelu(gate_v, approximate=True)
    else:
        gate = jax.nn.gelu(linear(h2, lp["ffn_gate"]).astype(jnp.float32), approximate=True)
        up = linear(h2, lp["ffn_up"]).astype(jnp.float32)
    ff = linear((gate * up).astype(x.dtype), lp["ffn_down"])
    if tp_axis is not None:  # col-sharded ffn_down -> partial sums
        ff = jax.lax.psum(ff, tp_axis)
    if "post_ffw_norm" in lp:  # Gemma-2/3 sandwich norm
        ff = rms_norm(ff, lp["post_ffw_norm"], cfg.rms_eps)
    x = x + ff
    record(f"blk.{layer_idx}.ffn_out", x)
    return x, cache


def _embed_lookup(embed, tokens: jax.Array, tp_axis: str | None,
                  dtype=jnp.bfloat16) -> jax.Array:
    """Token embedding gather. With `tp_axis`, the vocab rows are sharded
    over the axis: each shard gathers the ids it owns (others contribute
    zeros) and one psum assembles the full embedding."""
    n_local = embed.shape[0]  # QTensor.shape is shard-local under shard_map
    if tp_axis is not None:
        offset = jax.lax.axis_index(tp_axis) * n_local
        local = tokens - offset
        valid = (local >= 0) & (local < n_local)
        local = jnp.clip(local, 0, n_local - 1)
    else:
        local = tokens

    if hasattr(embed, "fmt"):  # quantized: gather rows, dequant only those
        from ..quant.qtensor import gather_dequant

        x = gather_dequant(embed, local, dtype)
    else:
        x = jnp.take(embed, local, axis=0).astype(dtype)
    if tp_axis is not None:
        x = jnp.where(valid[..., None], x, 0)
        x = jax.lax.psum(x, tp_axis)
    return x


def forward(
    params: Params,
    cfg: GemmaConfig,
    tokens: jax.Array,  # [B, T] int32
    positions: jax.Array,  # [B, T] int32 absolute positions
    cache: KVCache,
    write_index: jax.Array,  # scalar chunk start (prefill) or [B] slots (decode)
    kv_limit: jax.Array,  # [B] valid lengths after write
    tp_axis: str | None = None,  # see decoder_layer; cfg must be local
    logits_at: jax.Array | None = None,  # [B] row per seq; None = all rows
) -> tuple[jax.Array, KVCache]:
    """Full forward. Returns (logits [B, T, vocab] f32, updated cache).
    With `tp_axis`, the vocab dim of the returned logits is the LOCAL shard
    (callers all_gather or fold it into sampling).

    `logits_at` selects ONE row per sequence before the output head —
    prefill only needs the last token's logits, and the full head would be
    a [T, vocab] matmul plus a T x vocab x 4-byte HBM write per call (2.1
    GB at T=2048): returned logits are then [B, 1, vocab]."""
    x = _embed_lookup(params["embed"], tokens, tp_axis, cfg.act_dtype)
    x = (x.astype(jnp.float32) * (cfg.d_model**0.5)).astype(cfg.act_dtype)
    record("inp_embd", x)

    for i, lp in enumerate(params["layers"]):
        x, cache = decoder_layer(
            lp, cfg, x, positions, cache, i, write_index, kv_limit, tp_axis
        )

    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    record("result_norm", x)
    if logits_at is not None:
        x = jnp.take_along_axis(x, logits_at[:, None, None], axis=1)  # [B, 1, d]
    # Tied output head: logits = x @ embed.T (reference: gemma_model.cpp:163)
    logits = linear(x, params.get("output", params["embed"]), out_dtype=jnp.float32)
    if tp_axis is None and logits.shape[-1] != cfg.vocab_size:
        # drop vocab-padding rows (params.py pad_vocab); under tp the local
        # shard keeps the padding — callers slice after the all-gather
        logits = logits[..., : cfg.vocab_size]
    if cfg.final_softcap:
        logits = cfg.final_softcap * jnp.tanh(logits / cfg.final_softcap)
    record("result_output", logits)
    return logits, cache
