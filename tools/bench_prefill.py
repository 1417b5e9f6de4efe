#!/usr/bin/env python
"""Prefill throughput (tokens/s) — the other half of the reference's
runtime report (`/root/reference/src/gemma_model.cpp:566-572` logs prefill
AND decode rates).

Measures wall time of the compiled prefill program at several prompt
lengths (sync timing; the marginal between lengths removes the fixed
dispatch and fetch cost), both monolithic and chunked (512-token chunks,
config 4's long-prompt path).
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax

sys.path.insert(0, __file__.rsplit("/", 2)[0])
import numpy as np

from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()

from gemma_tpu.models import GEMMA_2B, GEMMA_7B
from gemma_tpu.runtime import Engine, EngineConfig
from gemma_tpu.testing import TINY_CONFIG, make_params


def _sync(logits):
    # a host fetch of the result forces real completion
    return np.asarray(logits[:1, :8])


def measure(eng, T, chunked, reps=5):
    prompt = [2 + i % 1000 for i in range(T)]
    fn = (lambda: eng.prefill_chunked([prompt], 512)) if chunked else (
        lambda: eng.prefill([prompt])
    )
    logits, _ = fn()
    _sync(logits)  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        logits, _ = fn()
        _sync(logits)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    model = sys.argv[1] if len(sys.argv) > 1 else "gemma2b"
    fmt = os.environ.get("BENCH_FMT", "q4_0")
    cfg = {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B, "tiny": TINY_CONFIG}[model]
    if model == "tiny":
        fmt = "bf16"
    t0 = time.time()
    params = jax.device_put(make_params(cfg, fmt=fmt, fill="zeros"))
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[:1])
    print(f"[+{time.time()-t0:.1f}s] params on device", file=sys.stderr, flush=True)

    eng = Engine(cfg, params, EngineConfig(max_seq_len=4096, max_batch=1,
                                           donate_cache=False))
    out = {}
    # marginal rate between two prompt lengths: the dispatch round-trip and
    # fetch constants are shared by both runs and cancel
    for name, chunked, T1, T2 in (
        ("mono", False, 1024, 2048),
        ("chunked", True, 2048, 4096),
    ):
        t1 = measure(eng, T1, chunked)
        t2 = measure(eng, T2, chunked)
        rate = (T2 - T1) / max(t2 - t1, 1e-9)
        out[f"{name}_T{T1}_to_T{T2}"] = round(rate, 1)
        print(
            f"[+{time.time()-t0:.1f}s] {name}: t({T1})={t1*1e3:.1f}ms "
            f"t({T2})={t2*1e3:.1f}ms marginal {rate:.0f} tok/s",
            file=sys.stderr, flush=True,
        )
    print(json.dumps({
        "metric": f"prefill_tokens_per_sec_{model}_{fmt}",
        **out, "unit": "tokens/s (marginal)",
    }))


if __name__ == "__main__":
    main()
