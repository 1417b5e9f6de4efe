#!/usr/bin/env python
"""Decompose the decode step: matmul-only stack vs the full step.

Marginal wall time between 1 and 1+R dispatches of one chained program
(cancels the fixed dispatch and fetch cost). Programs:

  matmuls   the model's actual per-token quantized matmuls (qkv, attn_out,
            gate_up, ffn_down per layer + lm_head), data-chained
  +attn     matmuls + the decode-attention kernel per layer (per-layer
            cache buffers at the engine's true geometry/limit)
  +ew       ... + the per-layer elementwise stack (4 rms_norms, rope on
            q and k, gelu gating, residuals) — the full step minus the
            cache write and the engine's carried-state plumbing
  step      Engine._decode (everything: + cache scatter; sampling is
            excluded — _decode returns logits)

Successive differences attribute the non-matmul stack: attention |
elementwise | cache-write + step overhead.
"""
from __future__ import annotations

import sys
import time

import jax

sys.path.insert(0, __file__.rsplit("/", 2)[0])
import jax.numpy as jnp
import numpy as np

from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()

from gemma_tpu.models import GEMMA_2B
from gemma_tpu.ops.quant_matmul import quant_matmul
from gemma_tpu.runtime import Engine, EngineConfig
from gemma_tpu.testing import make_params

CH = 8  # chained repetitions inside one program
R = 32


def marginal(prog, *args, reps=5):
    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = prog(*args)
        _ = np.asarray(out)
        return time.perf_counter() - t0

    run(1)  # compile
    vals = []
    for _ in range(reps):
        t1 = run(1)
        tr = run(1 + R)
        vals.append((tr - t1) / R / CH)
    vals.sort()
    return vals[len(vals) // 2]


def main():
    cfg = GEMMA_2B
    fmt = sys.argv[1] if len(sys.argv) > 1 else "q4_0"
    params = jax.device_put(make_params(cfg, fmt=fmt, fill="zeros"))
    jax.block_until_ready(jax.tree_util.tree_leaves(params))

    # -- matmul-only program ------------------------------------------------
    @jax.jit
    def matmuls(params, x):
        h = x  # [1, d_model]
        for _ in range(CH):
            for lp in params["layers"]:
                qkv = quant_matmul(h, lp["attn_qkv"])  # [1, q+2kv]
                a = quant_matmul(
                    qkv[:, : cfg.q_dim].astype(jnp.bfloat16), lp["attn_output"]
                )
                gu = quant_matmul(a.astype(jnp.bfloat16), lp["ffn_gate_up"])
                d = quant_matmul(
                    gu[:, : cfg.d_ff].astype(jnp.bfloat16), lp["ffn_down"]
                )
                h = (h + d * 1e-30).astype(jnp.bfloat16)
            logits = quant_matmul(h, params["embed"])
            h = (h + logits[:, : cfg.d_model] * 1e-30).astype(jnp.bfloat16)
        return h

    x = jnp.zeros((1, cfg.d_model), jnp.bfloat16)
    dt_mm = marginal(matmuls, params, x)
    print(f"matmul stack: {dt_mm*1e3:.3f} ms/token", flush=True)

    # -- + decode attention -------------------------------------------------
    from gemma_tpu.models.gemma import apply_rope, rms_norm
    from gemma_tpu.ops.attention import decode_attention

    S = 512
    rng = np.random.default_rng(0)
    ks = [
        jnp.asarray(rng.normal(size=(1, cfg.n_kv_heads, S, cfg.head_dim)) * 0.3, jnp.bfloat16)
        for _ in range(cfg.n_layers)
    ]
    vs = [jnp.asarray(np.asarray(k), jnp.bfloat16) for k in ks]
    lim = jnp.asarray([66], jnp.int32)

    @jax.jit
    def mm_attn(params, x, ks, vs, lim):
        h = x
        for _ in range(CH):
            for li, lp in enumerate(params["layers"]):
                qkv = quant_matmul(h, lp["attn_qkv"])
                q = qkv[:, : cfg.q_dim].reshape(1, 1, cfg.n_heads, cfg.head_dim)
                a = decode_attention(q.astype(jnp.bfloat16), ks[li], vs[li], lim)
                a = quant_matmul(
                    a.reshape(1, cfg.q_dim).astype(jnp.bfloat16), lp["attn_output"]
                )
                gu = quant_matmul(a.astype(jnp.bfloat16), lp["ffn_gate_up"])
                d = quant_matmul(
                    gu[:, : cfg.d_ff].astype(jnp.bfloat16), lp["ffn_down"]
                )
                h = (h + d * 1e-30).astype(jnp.bfloat16)
            logits = quant_matmul(h, params["embed"])
            h = (h + logits[:, : cfg.d_model] * 1e-30).astype(jnp.bfloat16)
        return h

    dt_attn = marginal(mm_attn, params, x, ks, vs, lim)
    print(f"+attention:   {dt_attn*1e3:.3f} ms/token "
          f"(attn {1e3*(dt_attn-dt_mm)/cfg.n_layers*1e3:.1f} us/layer)", flush=True)

    # -- + elementwise (norms, rope, gelu, residuals) -----------------------
    pos = jnp.asarray([[66]], jnp.int32)

    @jax.jit
    def mm_attn_ew(params, x, ks, vs, lim, pos):
        h = x[:, None, :]  # [1, 1, d_model]
        qscale = jnp.asarray(cfg.effective_query_scale, jnp.bfloat16)
        for _ in range(CH):
            for li, lp in enumerate(params["layers"]):
                hn = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
                qkv = quant_matmul(hn.reshape(1, cfg.d_model), lp["attn_qkv"])
                q = qkv[:, : cfg.q_dim].reshape(1, 1, cfg.n_heads, cfg.head_dim)
                k = qkv[:, cfg.q_dim : cfg.q_dim + cfg.kv_dim].reshape(
                    1, 1, cfg.n_kv_heads, cfg.head_dim
                )
                rope_base, rope_ps = cfg.layer_rope(li)
                q = apply_rope(q.astype(jnp.bfloat16), pos, rope_base, rope_ps) * qscale
                k = apply_rope(k.astype(jnp.bfloat16), pos, rope_base, rope_ps)
                a = decode_attention(
                    (q + k.sum() * 1e-30).astype(jnp.bfloat16), ks[li], vs[li], lim
                )
                a = quant_matmul(
                    a.reshape(1, cfg.q_dim).astype(jnp.bfloat16), lp["attn_output"]
                )
                h = h + a[:, None, :].astype(h.dtype)
                hn = rms_norm(h, lp["ffn_norm"], cfg.rms_eps)
                gu = quant_matmul(hn.reshape(1, cfg.d_model), lp["ffn_gate_up"]).astype(jnp.float32)
                gate = jax.nn.gelu(gu[:, : cfg.d_ff], approximate=True)
                d = quant_matmul(
                    (gate * gu[:, cfg.d_ff :]).astype(jnp.bfloat16), lp["ffn_down"]
                )
                h = h + d[:, None, :].astype(h.dtype)
            hn = rms_norm(h, params["final_norm"], cfg.rms_eps)
            logits = quant_matmul(hn.reshape(1, cfg.d_model), params["embed"])
            h = (h + logits[:, None, : cfg.d_model] * 1e-30).astype(jnp.bfloat16)
        return h

    dt_ew = marginal(mm_attn_ew, params, x, ks, vs, lim, pos)
    print(f"+elementwise: {dt_ew*1e3:.3f} ms/token "
          f"(ew {(dt_ew-dt_attn)*1e3:.3f} ms)", flush=True)

    # -- full decode step ---------------------------------------------------
    eng = Engine(cfg, params, EngineConfig(max_seq_len=512, max_batch=1))
    logits, cache = eng.prefill([list(range(2, 66))])
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    @jax.jit
    def step_chain(params, tok, cache):
        for _ in range(CH):
            logits, cache = eng._decode_impl(params, tok, cache)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return tok, cache

    def prog(params, tok, cache):
        t, _ = step_chain(params, tok, cache)
        return t

    dt_step = marginal(prog, eng.params, tok, cache)
    print(f"full step:    {dt_step*1e3:.3f} ms/token ({1/dt_step:.1f} tok/s)")
    print(f"non-matmul:   {(dt_step-dt_mm)*1e3:.3f} ms/token")
    print("attribution:  "
          f"attention {(dt_attn-dt_mm)*1e3:.3f}  "
          f"elementwise {(dt_ew-dt_attn)*1e3:.3f}  "
          f"cache-write+overhead {(dt_step-dt_ew)*1e3:.3f}  ms/token")


if __name__ == "__main__":
    main()
