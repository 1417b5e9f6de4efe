#!/usr/bin/env python
"""Decode throughput on one GPU, kernel path against plain path.

Measures steady-state batch-1 greedy decode tokens/s (the reference's own
headline workload, /root/reference/src/app.cpp:36) with the hand-written
kernels on, and with each kernel family routed to the plain XLA path
(ops._backend.plain_path), in one process, in turns: kernel, plain, plain,
kernel per variant. Prints the card's name and power limit, then ONE JSON
line. Fails without a GPU.

`roofline_share` is tokens/s times the bytes a decode step must read (every
weight in its device format, plus the live KV-cache) over the card's peak
bandwidth from utils/device.PEAKS.

Env: BENCH_MODEL (gemma2b|gemma7b), BENCH_FMT (q4_0|q8_0|q4_k|q6_k|
q4_k_m|bf16), BENCH_KV (comma list of dense|int8|paged), BENCH_CTX (cache
slots), BENCH_PROMPT (comma list of prompt lengths, i.e. the live length
at the start of decode), BENCH_TOKENS, BENCH_BLOCK (decode tokens per
dispatched program), BENCH_VARIANTS (comma list of kernel|plain-matmul|
plain-attention|plain).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gemma_tpu.compile_cache import setup_compile_cache  # noqa: E402

_T0 = time.time()


def _log(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def param_stream_bytes(params) -> int:
    """Bytes that must stream from device memory per decoded token (all
    weights), in the device format actually resident."""
    return sum(
        int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for leaf in jax.tree_util.tree_leaves(params)
    )


def kv_bytes(cfg, live: int, quantized: bool) -> int:
    """KV-cache bytes one decode step reads at `live` positions."""
    per = cfg.n_kv_heads * cfg.head_dim * (1 if quantized else 2)
    if quantized:
        per += cfg.n_kv_heads * 4  # f32 scale per (position, head)
    return 2 * cfg.n_layers * live * per


VARIANTS = {
    "kernel": (),
    "plain-matmul": ("matmul",),
    "plain-attention": ("attention",),
    "plain": ("matmul", "attention"),
}


def decode_rate(eng, prompt, n_tokens: int, reps: int = 3) -> float:
    """Marginal decode rate: t(2n) - t(n) over n extra tokens cancels the
    shared prefill + final-fetch cost; best of `reps`."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.generate_fused([prompt], max_new_tokens=n_tokens)
        t1 = time.perf_counter()
        eng.generate_fused([prompt], max_new_tokens=2 * n_tokens)
        t2 = time.perf_counter()
        dt = max((t2 - t1) - (t1 - t0), 1e-9)
        best = dt if best is None else min(best, dt)
    return n_tokens / best


def main() -> None:
    from gemma_tpu.models import GEMMA_2B, GEMMA_7B
    from gemma_tpu.ops import _backend
    from gemma_tpu.runtime import Engine, EngineConfig
    from gemma_tpu.testing import make_params
    from gemma_tpu.utils.device import device_peaks

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform}")
    setup_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)

    model = os.environ.get("BENCH_MODEL", "gemma2b")
    fmt = os.environ.get("BENCH_FMT", "q4_0")
    kvs = os.environ.get("BENCH_KV", "dense").split(",")
    ctx = int(os.environ.get("BENCH_CTX", "512"))
    plens = [int(p) for p in os.environ.get("BENCH_PROMPT", "64").split(",")]
    n_tokens = int(os.environ.get("BENCH_TOKENS", "64"))
    block = int(os.environ.get("BENCH_BLOCK", "8"))
    variants = os.environ.get("BENCH_VARIANTS", "kernel,plain").split(",")

    cfg = {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B}[model]
    params = jax.device_put(make_params(cfg, fmt=fmt))
    jax.block_until_ready(params)
    _log(f"params on device ({model} {fmt}, {cfg.n_layers} layers)")
    hbm = device_peaks().hbm_gbs * 1e9
    cells = {}
    for kv in kvs:
        ecfg = EngineConfig(
            max_seq_len=ctx, decode_block=block,
            kv_quantized=kv == "int8", paged=kv == "paged",
        )
        prompts = [[2 + i % 1000 for i in range(p)] for p in plens]
        engines = {}
        for v in variants:
            ops = VARIANTS[v]
            with _backend.plain_path(*ops) if ops else contextlib.nullcontext():
                eng = Engine(cfg, params, ecfg)
                for prompt in prompts:  # compile every shape the timing uses
                    eng.generate_fused([prompt], max_new_tokens=n_tokens)
                    eng.generate_fused([prompt], max_new_tokens=2 * n_tokens)
            engines[v] = eng
            _log(f"compiled {kv} {v}")
        for plen, prompt in zip(plens, prompts):
            rates: dict[str, list[float]] = {v: [] for v in variants}
            for order in (variants, variants[::-1]):
                for v in order:
                    rates[v].append(decode_rate(engines[v], prompt, n_tokens))
                    _log(f"{kv} prompt {plen} {v}: {rates[v][-1]:.2f} tok/s")
            live = plen + n_tokens  # mean live length over the marginal window
            step_bytes = param_stream_bytes(params) + kv_bytes(cfg, live, kv == "int8")
            cells[f"{kv}/{plen}"] = {
                "rates": rates,
                "step_bytes": step_bytes,
                "roofline_share": {
                    v: float(np.median(r)) * step_bytes / hbm for v, r in rates.items()
                },
            }
        del engines
    first = cells[f"{kvs[0]}/{plens[0]}"]["rates"][variants[0]]
    print(json.dumps({
        "metric": f"decode_tokens_per_sec_{model}_{fmt}_{kvs[0]}_b1",
        "value": float(np.median(first)),
        "unit": "tokens/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": smi,
        "n_layers": cfg.n_layers, "ctx": ctx, "tokens": n_tokens, "block": block,
        "cells": cells,
    }))


if __name__ == "__main__":
    main()
