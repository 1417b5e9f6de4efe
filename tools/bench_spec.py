#!/usr/bin/env python
"""Speculative-decoding throughput: plain greedy vs prompt-lookup spec.

Two workloads, because spec gains are CONTENT-DEPENDENT and an honest
bench shows both ends:
  repetitive  the model actually continues a cycle present in the prompt
              (stands in for code/extraction/quoting continuations where
              prompt-lookup shines) — measured with synthetic weights by
              CHECKING the emitted stream really cycles; if the random
              model breaks the cycle, acceptance (reported) shows it
  random      incompressible continuation — spec's worst case; the cost
              of rejected drafts is the (k+1)-row verify forward vs the
              1-row decode (both stream the same weight bytes)

    python tools/bench_spec.py [--model gemma2b] [--k 8]
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


def measure(fn, n_tokens, reps=5):
    # MEDIAN of marginals: a min is biased UP when the short run hiccups
    # (a hiccup in the short run inflates the marginal rate)
    ds = []
    out2 = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(n_tokens)
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        out2 = fn(2 * n_tokens)
        dt2 = time.perf_counter() - t1
        ds.append(max(dt2 - dt, 1e-9))
    ds.sort()
    return n_tokens / ds[len(ds) // 2], out2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gemma2b", choices=("gemma2b", "gemma7b", "tiny"))
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--block", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--fill", default="zeros", choices=("zeros", "random"),
                    help="random: a random-weight model whose greedy stream "
                    "is (mostly) incompressible — the mid-point between the "
                    "full-acceptance ceiling and the --force-reject floor")
    ap.add_argument("--force-reject", action="store_true",
                    help="draft-hostile floor: replace the bigram draft with "
                    "tokens guaranteed to fail verification (zeros fill => "
                    "argmax is always 0; drafting 1s rejects every draft), "
                    "so every verify forward emits exactly ONE token — the "
                    "measured zero-acceptance worst case")
    args = ap.parse_args()

    import numpy as np

    from gemma_tpu.models import GEMMA_2B, GEMMA_7B
    from gemma_tpu.runtime import Engine, EngineConfig
    from gemma_tpu.runtime.speculative import SpecDecoder
    from gemma_tpu.testing import TINY_CONFIG, make_params

    cfg = {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B, "tiny": TINY_CONFIG}[args.model]
    fmt = "bf16" if args.model == "tiny" else "q4_0"
    params = jax.device_put(make_params(cfg, fmt=fmt, fill=args.fill))
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[:1])
    eng = Engine(cfg, params, EngineConfig(max_seq_len=512, max_batch=1))
    spec = SpecDecoder(eng, k=args.k, block=args.block)
    if args.force_reject:
        import jax.numpy as jnp

        if args.fill != "zeros":
            raise SystemExit("--force-reject needs --fill zeros (argmax==0)")
        # patched before the first trace: every draft token is 1, argmax is
        # always 0 -> cumprod acceptance is 0 at position 0, n_emit == 1
        spec._draft = lambda history, hist_len, t_prev, t_cur: jnp.full(
            (spec.k,), 1, jnp.int32
        )

    # zero weights => logits all equal => argmax = token 0 everywhere =>
    # the greedy continuation is 0,0,0,... — a fully repetitive stream
    # (the best case); a random-ish prompt still exercises the machinery.
    rep_prompt = [0] * 32
    rnd_prompt = [2 + (i * 37) % 900 for i in range(32)]

    results = {}
    for name, prompt in (("repetitive", rep_prompt), ("random_prompt", rnd_prompt)):
        spec.generate(prompt, 8)  # compile
        eng.generate_fused([prompt], max_new_tokens=8)

        tps_plain, _ = measure(
            lambda n: eng.generate_fused([prompt], max_new_tokens=n), args.tokens
        )
        tps_spec, out = measure(lambda n: spec.generate(prompt, n), args.tokens)
        # accept-rate proxy: tokens per verify forward on the last run
        tpf = (2 * args.tokens) / max(spec.steps, 1)
        results[name] = {
            "plain_tok_s": round(tps_plain, 1),
            "spec_tok_s": round(tps_spec, 1),
            "speedup": round(tps_spec / tps_plain, 3),
            "tokens_per_verify": round(tpf, 2),
        }
        print(f"{name}: plain {tps_plain:.1f} spec {tps_spec:.1f} tok/s "
              f"({results[name]['speedup']}x, {tpf:.2f} tok/forward)",
              file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": f"speculative_decode_{args.model}_q4_0",
        **results, "k": args.k, "block": args.block, "fill": args.fill,
        "force_reject": args.force_reject,
    }))


if __name__ == "__main__":
    main()
