#!/usr/bin/env python
"""Profile the batched speculative serving tick.

Where a speculative tick costs far more than its verify forward, this
probe says where the time goes, with host-side wall timing over a steady
active batch (no admissions mid-loop):

  issue    _spec_issue dispatch time (no sync)
  drain    _spec_drain (np.asarray of a pipelined tick's handles)
  batch    raw SpecDecoder._batch_step dispatch+sync, chained

    python tools/probe_spec_serving.py
"""
from __future__ import annotations

import sys
import time

import jax

sys.path.insert(0, __file__.rsplit("/", 2)[0])
import numpy as np

from gemma_tpu.compile_cache import setup_compile_cache

setup_compile_cache()

from gemma_tpu.models import GEMMA_2B
from gemma_tpu.runtime import Engine, EngineConfig
from gemma_tpu.runtime.scheduler import Request, Scheduler
from gemma_tpu.testing import make_params


def main():
    cfg = GEMMA_2B
    B = 8
    params = jax.device_put(make_params(cfg, fmt="q4_0", fill="zeros"))
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[:1])
    eng = Engine(cfg, params, EngineConfig(max_seq_len=512, max_batch=B))
    sched = Scheduler(eng, speculative=True, spec_k=7)
    for i in range(B):
        sched.submit(Request(
            id=f"r{i}", prompt=[2 + (j + i) % 1000 for j in range(64)],
            max_new_tokens=400,
        ))
    # admit everything, compile one tick
    sched._advance_admissions(); sched._admit()
    print(f"active={len(sched.active)}", flush=True)
    t0 = time.perf_counter()
    sched._spec_issue()
    sched._spec_drain()
    print(f"first tick (compile) {time.perf_counter()-t0:.1f}s", flush=True)

    # steady state: issue/drain pipelined, timed separately
    it, dt = [], []
    for _ in range(30):
        t0 = time.perf_counter()
        sched._spec_issue()
        t1 = time.perf_counter()
        if len(sched._spec_pending) >= 2:
            sched._spec_drain()
        t2 = time.perf_counter()
        it.append(t1 - t0)
        dt.append(t2 - t1)
    it.sort(); dt.sort()
    print(f"issue p50 {it[15]*1e3:7.2f} ms   drain p50 {dt[15]*1e3:7.2f} ms",
          flush=True)

    # scheduler-context issues with ONE final sync: pure device tick rate
    while sched._spec_pending:
        sched._spec_drain()
    t0 = time.perf_counter()
    for _ in range(30):
        sched._spec_issue()
    g_last, n_last, _ = sched._spec_pending[-1]
    np.asarray(n_last)
    print(f"30 issues + 1 sync: {(time.perf_counter()-t0)/30*1e3:7.2f} ms/tick",
          flush=True)
    fetch = []
    while sched._spec_pending:
        g, n, _ = sched._spec_pending.popleft()
        t0 = time.perf_counter()
        np.asarray(g); np.asarray(n)
        fetch.append(time.perf_counter() - t0)
    fetch.sort()
    print(f"post-sync fetch p50 {fetch[len(fetch)//2]*1e3:7.2f} ms", flush=True)

    # raw batched step, chained x8 then one sync
    tc, tp, hist, hlen = sched._sp_carry
    cache = sched.cache
    t0 = time.perf_counter()
    for _ in range(8):
        tc, tp, hist, hlen, g, n, cache = sched.spec._batch_step(
            eng.params, tc, tp, hist, hlen, cache
        )
    np.asarray(n)
    print(f"raw batch_step chained x8: {(time.perf_counter()-t0)/8*1e3:7.2f} ms each",
          flush=True)


if __name__ == "__main__":
    main()
