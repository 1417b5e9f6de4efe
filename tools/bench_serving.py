#!/usr/bin/env python
"""Continuous-batching serving benchmark (BASELINE config 3).

Drives the Scheduler with a backlog of requests against a batch-N decode
pool and reports aggregate decode throughput + TTFT percentiles — the
serving-side numbers the reference cannot produce at all (it decodes one
hardcoded prompt per process, /root/reference/src/gemma_model.cpp:548-575).

    python tools/bench_serving.py [--batch 8] [--requests 24] [--block 8]

The scheduler decodes in fused `--block`-token programs (one host sync per
block); set --block 1 for the per-token admission latency mode.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gemma2b", choices=("gemma2b", "gemma7b", "tiny"))
    ap.add_argument("--fmt", default="q4_0")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV-cache (config 3: INT8 KV)")
    ap.add_argument("--admit-per-tick", type=int, default=None,
                    help="cap admissions per decode tick (TTFT vs ramp)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="overlapped admission: admit one prefill chunk "
                    "per decode tick instead of a full-prompt stall")
    ap.add_argument("--speculative", action="store_true",
                    help="batched speculative ticks (greedy, dense cache): "
                    "every slot drafts+verifies spec-k tokens per tick; "
                    "the run loop pipelines --spec-pipeline ticks in flight")
    ap.add_argument("--spec-k", type=int, default=7)
    ap.add_argument("--spec-pipeline", type=int, default=2)
    ap.add_argument("--spec-block", type=int, default=4,
                    help="chained verify ticks per dispatch (one host "
                         "fetch per block)")
    ap.add_argument("--fill", default="zeros", choices=("zeros", "random"),
                    help="weight fill: zeros => fully repetitive greedy "
                    "streams (spec ceiling); random => mostly-incompressible "
                    "streams (spec mid-point)")
    args = ap.parse_args()

    from gemma_tpu.models import GEMMA_2B, GEMMA_7B
    from gemma_tpu.runtime import Engine, EngineConfig
    from gemma_tpu.runtime.scheduler import Request, Scheduler
    from gemma_tpu.testing import TINY_CONFIG, make_params

    cfg = {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B, "tiny": TINY_CONFIG}[args.model]
    fmt = "bf16" if args.model == "tiny" else args.fmt
    t0 = time.time()
    params = jax.device_put(make_params(cfg, fmt=fmt, fill=args.fill))
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[:1])
    print(f"[+{time.time()-t0:.1f}s] params on device", file=sys.stderr, flush=True)

    eng = Engine(
        cfg, params,
        EngineConfig(
            max_seq_len=args.max_seq_len, max_batch=args.batch,
            paged=args.paged, kv_quantized=args.kv_quant,
            prefill_chunk=args.prefill_chunk,
        ),
    )

    def make_requests():
        return [
            Request(
                id=f"r{i}",
                prompt=[2 + (j + i) % 1000 for j in range(args.prompt_len)],
                max_new_tokens=args.max_new,
            )
            for i in range(args.requests)
        ]

    spec_kw = dict(
        speculative=args.speculative, spec_k=args.spec_k,
        spec_pipeline=args.spec_pipeline, spec_block=args.spec_block,
    )

    # warmup: compile prefill bucket + the blocked decode program
    sched = Scheduler(eng, **spec_kw)
    for r in make_requests()[: args.batch]:
        sched.submit(r)
    sched.run(block=args.block)
    print(f"[+{time.time()-t0:.1f}s] compiled/warm", file=sys.stderr, flush=True)

    # measured run: full backlog submitted at t=0 (offline-throughput mode)
    sched = Scheduler(eng, admit_per_tick=args.admit_per_tick, **spec_kw)
    for r in make_requests():
        sched.submit(r)
    t1 = time.monotonic()
    finished = sched.run(block=args.block)
    wall = time.monotonic() - t1

    stats = sched.stats()
    useful = sum(min(len(r.tokens), r.max_new_tokens) for r in finished)
    out = {
        "metric": f"serving_tokens_per_sec_{args.model}_{fmt}_b{args.batch}",
        "value": round(useful / wall, 2),
        "unit": "tokens/s",
        "requests": stats["requests"],
        "decode_steps": stats["decode_steps"],
        "p50_ttft_s": round(stats["p50_ttft_s"], 4),
        "p99_ttft_s": round(stats["p99_ttft_s"], 4),
        "block": args.block,
        "wall_s": round(wall, 2),
        "admit_per_tick": args.admit_per_tick,
        "prefill_chunk": args.prefill_chunk,
        "kv_quant": args.kv_quant,
        "fill": args.fill,
    }
    if args.speculative:
        out["speculative"] = {
            "k": args.spec_k, "pipeline": args.spec_pipeline,
            "spec_block": args.spec_block,
            "spec_forwards": stats["spec_forwards"],
            "tokens_discarded": stats["tokens_discarded"],
            "accepted_tokens_per_verify": round(
                useful / max(stats["spec_forwards"], 1), 2
            ),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
