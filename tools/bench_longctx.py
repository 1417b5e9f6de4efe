#!/usr/bin/env python
"""Long-context benchmark (BASELINE config 4): 2K-8K decode, paged vs dense.

Prefills a long prompt and measures steady-state decode tokens/s at the
resulting context length, for the dense KV-cache and the paged pool (the
decode kernel walking the block table, ops/attention.py). The
reference hard-caps context at 512 (/root/reference/src/macro.h:8-9); this
is the capability BASELINE.json adds on top.

    python tools/bench_longctx.py [--ctx 8192] [--prefill 4096] [--page-size 64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()


def measure_decode(eng, prompt, n_tokens, repeats=3):
    """Marginal decode rate between n and 2n generated tokens (cancels the
    shared prefill + final-fetch constant). Takes the min wall time of
    `repeats` runs at each length
    so one scheduling hiccup can't produce a nonsense marginal."""
    eng.generate_fused([prompt], max_new_tokens=8)  # compile
    eng.generate_fused([prompt], max_new_tokens=n_tokens)  # compile 2nd shape
    eng.generate_fused([prompt], max_new_tokens=2 * n_tokens)

    def best(n):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            eng.generate_fused([prompt], max_new_tokens=n)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    dt = best(2 * n_tokens) - best(n_tokens)
    if dt <= 0:
        return float("nan")
    return n_tokens / dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gemma2b", choices=("gemma2b", "gemma7b", "tiny"))
    ap.add_argument("--fmt", default="q4_0")
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--prefill", type=int, default=4096)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV page length (default: engine's "
                         "geometry-aware pick — 64, or 256 for MQA "
                         "long-context)")
    args = ap.parse_args()

    from gemma_tpu.models import GEMMA_2B, GEMMA_7B
    from gemma_tpu.runtime import Engine, EngineConfig
    from gemma_tpu.testing import TINY_CONFIG, make_params

    cfg = {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B, "tiny": TINY_CONFIG}[args.model]
    fmt = "bf16" if args.model == "tiny" else args.fmt
    t0 = time.time()
    params = jax.device_put(make_params(cfg, fmt=fmt, fill="zeros"))
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[:1])
    print(f"[+{time.time()-t0:.1f}s] params on device", file=sys.stderr, flush=True)

    prompt = [2 + i % 1000 for i in range(args.prefill)]
    results = {}
    # int8-KV variants prove config 3's promise: the fused kernels read
    # int8 in place, so a long context should decode FASTER than bf16
    for name, paged, kvq in (
        ("dense", False, False),
        ("paged", True, False),
        ("dense_int8kv", False, True),
        ("paged_int8kv", True, True),
    ):
        eng = Engine(
            cfg, params,
            EngineConfig(
                max_seq_len=args.ctx, max_batch=1,
                paged=paged, page_size=args.page_size, kv_quantized=kvq,
                # long prompts prefill in fixed 512-token chunks: one
                # compiled shape regardless of prompt length (config 4)
                prefill_chunk=512,
            ),
        )
        tps = measure_decode(eng, prompt, args.tokens)
        results[name] = round(tps, 2)
        if paged:
            results["page_size_resolved"] = eng.ecfg.page_size
        print(f"[+{time.time()-t0:.1f}s] {name}: {tps:.2f} tok/s", file=sys.stderr, flush=True)

    print(
        json.dumps(
            {
                "metric": f"longctx_decode_tokens_per_sec_{args.model}_{fmt}_ctx{args.ctx}",
                "prefill_tokens": args.prefill,
                **results,
                "page_size": args.page_size,
                "unit": "tokens/s",
            }
        )
    )


if __name__ == "__main__":
    main()
