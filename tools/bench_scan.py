#!/usr/bin/env python
"""Compare host-chained decode dispatch vs device-side lax.scan multi-step.

Measures whether a device-side scan of decode steps beats the engine's
host-chained dispatch at current kernel shapes, to decide the
generate_fused strategy."""
import os
import sys
import time

import jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax.numpy as jnp
import numpy as np

from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()

from gemma_tpu.models import GEMMA_2B, gemma
from gemma_tpu.runtime import Engine, EngineConfig
from gemma_tpu.testing import make_params

cfg = GEMMA_2B
params = jax.device_put(make_params(cfg, fmt="q4_0", fill="zeros"))
jax.block_until_ready(jax.tree_util.tree_leaves(params))
eng = Engine(cfg, params, EngineConfig(max_seq_len=512, max_batch=1))
logits, cache = eng.prefill([list(range(2, 66))])
tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

N = 32


def scan_steps(params, tok, cache, n):
    def body(carry, _):
        tok, cache = carry
        logits, cache = eng._decode_impl(params, tok, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (tok, cache), tok

    (tok, cache), toks = jax.lax.scan(body, (tok, cache), None, length=n)
    return toks, cache


scan_jit = jax.jit(scan_steps, static_argnums=(3,), donate_argnums=(2,))

t0 = time.time()
toks, cache = scan_jit(params, tok, cache, N)
jax.block_until_ready(toks)
print(f"scan compile+run: {time.time()-t0:.1f}s")

for _ in range(2):
    t0 = time.perf_counter()
    toks, cache = scan_jit(params, tok, cache, N)
    jax.block_until_ready(toks)
    dt = time.perf_counter() - t0
    print(f"scan: {dt/N*1e3:.3f} ms/token ({N/dt:.1f} tok/s)")

# chained dispatch (current generate_fused inner loop, greedy key-free)
def chain(tok, cache, n):
    toks = []
    for _ in range(n):
        logits, cache = eng._decode(params, tok, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
    return toks, cache

toks, cache = chain(tok, cache, N)
jax.block_until_ready(toks[-1])
for _ in range(2):
    t0 = time.perf_counter()
    toks, cache = chain(tok, cache, N)
    jax.block_until_ready(toks[-1])
    dt = time.perf_counter() - t0
    print(f"chain(argmax outside): {dt/N*1e3:.3f} ms/token ({N/dt:.1f} tok/s)")
