#!/usr/bin/env python
"""Scaling-efficiency harness (BASELINE config 5: >= 85 % at 1 -> N hosts).

Measures decode tokens/s of the data-parallel serving path at growing mesh
sizes. On a real multi-host cluster, run once per configuration (the data
axis spans hosts; see parallel/multihost.py); without one, it runs on N
virtual CPU devices — the numbers are then only about the harness/sharding correctness,
not absolute speed, but the efficiency math and the measurement path are
the same.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_scaling.py

Prints one line per mesh size + a final JSON summary.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# default to an 8-virtual-device CPU platform when no real multi-chip mesh
if "XLA_FLAGS" not in os.environ:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax

from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()

import numpy as np

from gemma_tpu.models.config import GemmaConfig
from gemma_tpu.parallel import make_mesh
from gemma_tpu.parallel.multihost import scaling_efficiency
from gemma_tpu.parallel.shard_decode import TPEngine
from gemma_tpu.testing import make_params

CFG = GemmaConfig(
    vocab_size=2048, d_model=512, n_layers=4, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=1024, context_length=256,
)
TOKENS = int(os.environ.get("SCALE_TOKENS", "32"))
BATCH_PER_SHARD = int(os.environ.get("SCALE_BATCH", "2"))


def measure(n_devices: int, tp: int = 1) -> float:
    mesh = make_mesh(n_devices // tp, tp, devices=jax.devices()[:n_devices])
    batch = BATCH_PER_SHARD * (n_devices // tp)
    params = make_params(CFG, fmt="bf16", fill="random")
    eng = TPEngine(CFG, params, mesh, max_seq_len=128, max_batch=batch)
    prompts = [[1, 5 + i, 9, 300 + i] for i in range(batch)]
    # warm
    eng.generate_greedy(prompts, max_new_tokens=4)
    t0 = time.perf_counter()
    out = eng.generate_greedy(prompts, max_new_tokens=TOKENS)
    dt = time.perf_counter() - t0
    assert out.shape == (batch, TOKENS)
    return TOKENS * batch / dt


def main() -> None:
    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= n_dev]
    tp = int(os.environ.get("SCALE_TP", "1"))
    results: dict[int, float] = {}
    for n in sizes:
        if n % tp:
            continue
        tps = measure(n, tp)
        results[n] = tps
        print(f"mesh={n:3d} (tp={tp}) batch={BATCH_PER_SHARD * (n // tp)}: "
              f"{tps:9.1f} tok/s", flush=True)
    eff = scaling_efficiency(results)
    print(json.dumps({
        "metric": "scaling_efficiency",
        "tokens_per_sec": {str(k): round(v, 1) for k, v in results.items()},
        "efficiency": {str(k): round(v, 3) for k, v in eff.items()},
        "devices": str(jax.devices()[0].device_kind),
    }))


if __name__ == "__main__":
    main()
