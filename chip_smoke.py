#!/usr/bin/env python
"""Smoke test of gemma-tpu on one NVIDIA GPU, through the entry points a
user calls, at the full width of Gemma-2B (depth cut, seeded random
weights).

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the tensor-parallel path only

Phases, each printed as it finishes:

1. device   platform, device kind and count as JAX reports them, the card's
            name and power limit from nvidia-smi, the JAX version, XLA_FLAGS;
2. kernels  every hand-written kernel, compiled, against the plain
            reference at real widths (all Gemma-2B and Gemma-7B projections
            at a decode M and a prefill M; decode attention at S = 512 and
            4096 over several live lengths, bf16, int8 and paged), with its
            time beside the time of the plain version XLA compiles;
3. e2e      serve() over q4_0 and q4_k_m weights with dense, int8 and paged
            caches, a KV hand-off over a socket to a prefill thread, and
            utils.verify's kernel-vs-plain comparison;
4. cli      `python -m gemma_tpu generate` (in this process) on a GGUF made
            by gemma_tpu.testing.make_gguf: loader, tokenizer, generation;
5. memory   compiled.memory_analysis() of the full-depth 2B decode step,
            its decode rate, and the device's peak_bytes_in_use.

Any failed phase exits non-zero. Without a GPU the script exits non-zero at
once, and prints no result. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gemma_tpu.models.config import GemmaConfig  # noqa: E402

# relative to max |reference|: bf16 rounding of the dequantized weights
# (2^-9) summed over K in f32, with margin
MATMUL_TOL = 2e-2
# absolute, on attention outputs of O(0.3) values: the kernel rounds the
# softmax weights to bf16 for the p @ v tensor-core dot
ATTN_TOL = 2e-2
DECODE_M = 1
PREFILL_M = 512
E2E_LAYERS = 2


class NoGPU(RuntimeError):
    pass


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_report(require_gpu: bool = True) -> dict:
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    log("device", f"platform={info['platform']} kind={info['kind']} count={info['count']}")
    if require_gpu and info["platform"] != "gpu":
        raise NoGPU(f"JAX found no GPU (platform {info['platform']})")
    if require_gpu:
        log("device", "nvidia-smi name, power.limit:")
        print(nvidia_smi(), flush=True)  # as nvidia-smi prints it, one line per card
    log("device", f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return info


def loop_time_us(op, *args, n: int = 50, reps: int = 3) -> float:
    """Device time of one op(*args) call: n dependent calls in one jitted
    loop (the carry feeds the first argument, so nothing is hoisted), best
    of `reps`, divided by n."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(*a):
        def body(i, c):
            x = a[0] + (c * 1e-30).astype(a[0].dtype)
            return c + op(x, *a[1:]).astype(jnp.float32).sum() * 1e-30

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    jax.block_until_ready(run(*args))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best / n * 1e6


def projection_shapes(cfg: GemmaConfig) -> dict[str, tuple[int, int]]:
    """(N, K) = (out, in) of every matmul of one layer plus the head."""
    return {
        "qkv": (cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model),
        "attn_out": (cfg.d_model, cfg.q_dim),
        "gate_up": (2 * cfg.d_ff, cfg.d_model),
        "ffn_down": (cfg.d_model, cfg.d_ff),
        "lm_head": (cfg.padded_vocab_size, cfg.d_model),
    }


def check_matmul(fmt: str, N: int, K: int, M: int, seed: int = 0,
                 timing: bool = True) -> dict:
    """Kernel vs the f32 reference (x @ dequant(w), precision highest), at
    any M; `path` says what the dispatch runs at this M."""
    import jax
    import jax.numpy as jnp

    from gemma_tpu.ops.quant_matmul import matmul, plain_matmul, quant_matmul, tiles
    from gemma_tpu.quant.qtensor import dequant_t
    from gemma_tpu.testing import random_matrix

    rng = np.random.default_rng(seed)
    w = jax.device_put(random_matrix(rng, N, K, fmt))
    x = jnp.asarray(rng.standard_normal((M, K), np.float32), jnp.bfloat16)
    if not tiles(w):
        raise AssertionError(f"{fmt} [{N}, {K}] does not tile for the kernel")
    got = np.asarray(jax.jit(quant_matmul)(x, w))
    path = matmul(x, w)[1]  # what the dispatch runs at this M
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(
            lambda x, w: jnp.dot(x.astype(jnp.float32), dequant_t(w, jnp.float32))
        )(x, w))
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    res = {
        "fmt": fmt, "N": N, "K": K, "M": M, "path": path,
        "max_abs": err, "max_rel": err / scale, "tol_rel": MATMUL_TOL,
        "ok": bool(np.isfinite(got).all() and err <= MATMUL_TOL * scale),
    }
    if timing:
        res["kernel_us"] = loop_time_us(quant_matmul, x, w)
        res["plain_us"] = loop_time_us(plain_matmul, x, w)
    return res


def _quant_rows(x: np.ndarray):
    """Per-(position, head) symmetric int8 over D, as runtime.kv_cache."""
    amax = np.abs(x).max(axis=-1)
    scale = amax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale == 0, 1.0, scale), 0.0)
    return np.round(x * inv[..., None]).astype(np.int8), scale.astype(np.float32)


def check_decode_attention(S: int, Hq: int, Hkv: int, D: int, limits: list[int],
                           mode: str = "bf16", softcap: float = 0.0,
                           window: int = 0, page_size: int = 64, seed: int = 0,
                           timing: bool = False) -> dict:
    """Decode kernel (mode bf16 | int8 | paged) vs sdpa_xla in f32 on the
    same (dequantized) keys and values."""
    import jax
    import jax.numpy as jnp

    from gemma_tpu.ops.attention import (
        decode_attention, paged_decode_attention, sdpa_xla,
    )
    from gemma_tpu.runtime.paged_kv import PagedKVCache

    rng = np.random.default_rng(seed)
    B = len(limits)
    q = jnp.asarray(rng.standard_normal((B, 1, Hq, D)) * 0.3, jnp.bfloat16)
    kf = (rng.standard_normal((B, Hkv, S, D)) * 0.3).astype(np.float32)
    vf = (rng.standard_normal((B, Hkv, S, D)) * 0.3).astype(np.float32)
    kv_limit = jnp.asarray(limits, jnp.int32)
    ks = vs = None
    if mode == "int8":
        qk, ks = _quant_rows(kf)
        qv, vs = _quant_rows(vf)
        kf, vf = qk * ks[..., None], qv * vs[..., None]
        k, v = jnp.asarray(qk), jnp.asarray(qv)
        ks, vs = jnp.asarray(ks), jnp.asarray(vs)
    else:
        k = jnp.asarray(kf, jnp.bfloat16)
        v = jnp.asarray(vf, jnp.bfloat16)
        kf = np.asarray(k, np.float32)
        vf = np.asarray(v, np.float32)

    if mode == "paged":
        maxp = S // page_size
        perm = rng.permutation(B * maxp) + 1  # page 0 is the trash page

        def pages(x):  # [B, H, S, D] -> pool [1 + B*maxp, H, ps, D]
            pool = np.zeros((1 + B * maxp, Hkv, page_size, D), np.float32)
            blk = x.reshape(B, Hkv, maxp, page_size, D).transpose(0, 2, 1, 3, 4)
            pool[perm] = blk.reshape(B * maxp, Hkv, page_size, D)
            return jnp.asarray(pool, jnp.bfloat16)

        state = PagedKVCache(
            k_pages=(pages(kf),), v_pages=(pages(vf),),
            page_table=jnp.asarray(perm.reshape(B, maxp), jnp.int32),
            length=kv_limit,
        )

        def op(q, kv_limit, cache):
            return paged_decode_attention(q, cache, 0, kv_limit, softcap, window)

        def plain(q, kv_limit, cache):
            kd, vd = cache.gather_layer(0)
            return sdpa_xla(q, kd, vd, (kv_limit - 1)[:, None], kv_limit,
                            softcap, window)
    else:
        state = (k, v, ks, vs)

        def op(q, kv_limit, state):
            k, v, ks, vs = state
            return decode_attention(q, k, v, kv_limit, softcap, window,
                                    k_scale=ks, v_scale=vs)

        def plain(q, kv_limit, state):
            k, v, ks, vs = state
            if ks is not None:
                k = k.astype(jnp.bfloat16) * ks[..., None].astype(jnp.bfloat16)
                v = v.astype(jnp.bfloat16) * vs[..., None].astype(jnp.bfloat16)
            return sdpa_xla(q, k, v, (kv_limit - 1)[:, None], kv_limit,
                            softcap, window)

    got = np.asarray(jax.jit(op)(q, kv_limit, state), np.float32)
    positions = (kv_limit - 1)[:, None]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(
            lambda q, k, v: sdpa_xla(q.astype(jnp.float32), k, v, positions,
                                     kv_limit, softcap, window)
        )(q, jnp.asarray(kf), jnp.asarray(vf)), np.float32)
    err = float(np.abs(got - ref).max())
    res = {
        "mode": mode, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "limits": limits,
        "softcap": softcap, "window": window, "max_abs": err,
        "max_rel": err / float(np.abs(ref).max()), "tol_abs": ATTN_TOL,
        "ok": bool(np.isfinite(got).all() and err <= ATTN_TOL),
    }
    if timing:
        res["kernel_us"] = loop_time_us(op, q, kv_limit, state)
        res["plain_us"] = loop_time_us(plain, q, kv_limit, state)
    return res


def _report(phase: str, res: dict) -> bool:
    keys = [k for k in res if k not in ("ok",)]
    body = " ".join(
        f"{k}={res[k]:.4g}" if isinstance(res[k], float) else f"{k}={res[k]}"
        for k in keys
    )
    log(phase, f"{'ok  ' if res['ok'] else 'FAIL'} {body}")
    return res["ok"]


def kernel_phase(matmul_cases, attention_cases, timing: bool = True) -> list[dict]:
    """matmul_cases: (fmt, N, K, M); attention_cases: kwargs of
    check_decode_attention. Raises if any kernel misses its tolerance."""
    log("kernels", "precision: kernels bf16 operands, f32 accumulation; "
        "references f32 under jax.default_matmul_precision('highest')")
    results, ok = [], True
    for fmt, N, K, M in matmul_cases:
        res = check_matmul(fmt, N, K, M, timing=timing)
        ok &= _report("kernels", res)
        results.append(res)
    for kw in attention_cases:
        res = check_decode_attention(**kw)
        ok &= _report("kernels", res)
        results.append(res)
    if not ok:
        raise AssertionError("a kernel missed its tolerance")
    return results


def default_matmul_cases() -> list[tuple[str, int, int, int]]:
    from gemma_tpu.models import GEMMA_2B, GEMMA_7B

    cases = []
    for cfg in (GEMMA_2B, GEMMA_7B):
        for N, K in projection_shapes(cfg).values():
            for M in (DECODE_M, PREFILL_M):
                cases.append(("q4_0", N, K, M))
    for fmt in ("q8_0", "q4_k", "q6_k"):  # the other formats, 2B decode
        for N, K in projection_shapes(GEMMA_2B).values():
            cases.append((fmt, N, K, DECODE_M))
    return cases


def default_attention_cases() -> list[dict]:
    cases = []
    for Hq, Hkv in ((8, 1), (16, 16)):  # Gemma-2B MQA, Gemma-7B MHA
        for S, limits in ((512, [1, 200, 512]), (4096, [300, 2048, 4096])):
            for mode in ("bf16", "int8", "paged"):
                cases.append(dict(S=S, Hq=Hq, Hkv=Hkv, D=256, limits=limits, mode=mode))
    cases.append(dict(S=4096, Hq=8, Hkv=1, D=256, limits=[3000], softcap=50.0,
                      window=1024))
    # the decode cells that decide whether the kernel stays (7B, 4096 slots)
    for live in (512, 2048):
        for mode in ("bf16", "int8", "paged"):
            cases.append(dict(S=4096, Hq=16, Hkv=16, D=256, limits=[live],
                              mode=mode, timing=True))
    return cases


def cut(cfg: GemmaConfig, n_layers: int) -> GemmaConfig:
    return dataclasses.replace(cfg, n_layers=n_layers)


def _check_tokens(sched, reqs, vocab: int) -> None:
    done = {r.id: r for r in sched.finished}
    for r in reqs:
        toks = done[r.id].tokens
        if len(toks) != r.max_new_tokens or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {r.id}: bad tokens {toks}")


def e2e_phase(cfg: GemmaConfig, fmts=("q4_0", "q4_k_m"),
              caches=("dense", "int8", "paged"), max_seq_len: int = 256,
              page_size: int = 64, n_requests: int = 3, new_tokens: int = 8,
              seed: int = 0) -> None:
    """serve() through the Scheduler for every (format, cache); a KV hand-off
    over a socket to a prefill thread; verify_device_kernels per cache."""
    import socket
    import threading

    import jax

    from gemma_tpu.runtime import Engine, EngineConfig, serve
    from gemma_tpu.runtime.kv_transfer import RemotePrefillClient, prefill_server
    from gemma_tpu.runtime.scheduler import Request, Scheduler
    from gemma_tpu.testing import make_params
    from gemma_tpu.utils.verify import format_report, verify_device_kernels

    rng = np.random.default_rng(seed)
    prompts = [
        [int(t) for t in rng.integers(2, cfg.vocab_size, size=5 + 17 * i)]
        for i in range(n_requests)
    ]
    def requests():
        return [Request(f"r{i}", p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]

    reqs = requests()
    for fmt in fmts:
        params = jax.device_put(make_params(cfg, fmt, seed=seed))
        for cache in caches:
            ecfg = EngineConfig(
                max_seq_len=max_seq_len, max_batch=2,
                kv_quantized=cache == "int8", paged=cache == "paged",
                page_size=page_size if cache == "paged" else None,
            )
            t0 = time.perf_counter()
            sched = serve(Engine(cfg, params, ecfg), requests(), block=4)
            _check_tokens(sched, reqs, cfg.vocab_size)
            log("e2e", f"ok   serve {fmt} {cache}: {sched.stats()} "
                f"({time.perf_counter() - t0:.1f} s with compiles)")
        if fmt == fmts[0]:
            for cache in caches:
                res = verify_device_kernels(
                    cfg, params, prompts[-1], n_decode=4,
                    max_seq_len=max_seq_len, kv_quantized=cache == "int8",
                    paged=cache == "paged", page_size=page_size,
                )
                for line in format_report(res).splitlines():
                    log("e2e", f"verify {fmt} {cache}: {line}")
                if not res["ok"]:
                    raise AssertionError(f"verify {fmt} {cache} failed")
            # prefill on a thread behind a socket, decode here: the KV
            # hand-off crosses a real serialization boundary
            srv, cli = socket.socketpair()
            pre = Engine(cfg, params, EngineConfig(max_seq_len=max_seq_len))
            t = threading.Thread(target=prefill_server, args=(pre, srv), daemon=True)
            t.start()
            client = RemotePrefillClient(cli)
            try:
                sched = Scheduler(
                    Engine(cfg, params, EngineConfig(max_seq_len=max_seq_len, max_batch=2)),
                    prefill_engine=client,
                )
                for r in requests():
                    sched.submit(r)
                sched.run(block=4)
            finally:
                client.close()
                t.join(timeout=60)
            if t.is_alive():
                raise AssertionError("prefill thread did not stop")
            _check_tokens(sched, reqs, cfg.vocab_size)
            log("e2e", f"ok   KV hand-off over a socket: {sched.stats()}")
        del params


def cli_phase(cfg: GemmaConfig, workdir: str) -> None:
    """`python -m gemma_tpu generate` on a fabricated q4_0 GGUF, in-process."""
    import contextlib
    import io

    from gemma_tpu import cli
    from gemma_tpu.gguf import GGMLType
    from gemma_tpu.testing import make_gguf

    path = make_gguf(os.path.join(workdir, "smoke.gguf"), cfg,
                     weight_type=GGMLType.Q4_0, seed=1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["generate", str(path), "--prompt", "hello world",
                       "--max-new-tokens", "8", "--no-eos"])
    text = out.getvalue()
    log("cli", f"generate rc={rc} output={text.strip()[:200]!r}")
    if rc != 0:
        raise AssertionError(f"generate exited {rc}")


def memory_phase(cfg: GemmaConfig, fmt: str = "q4_0", new_tokens: int = 64,
                 max_seq_len: int = 512) -> dict:
    """Decode-step memory analysis and decode rate of the full model."""
    import jax
    import jax.numpy as jnp

    from gemma_tpu.runtime import Engine, EngineConfig
    from gemma_tpu.runtime.sampler import SamplingParams
    from gemma_tpu.testing import make_params

    params = jax.device_put(make_params(cfg, fmt))
    eng = Engine(cfg, params, EngineConfig(max_seq_len=max_seq_len, decode_block=1))
    prompt = list(range(2, 2 + min(64, max_seq_len // 2)))
    logits, cache = eng.prefill([prompt])
    compiled = eng._step.lower(
        params, logits, jax.random.PRNGKey(0), cache, sampling=SamplingParams()
    ).compile()
    mem = compiled.memory_analysis()
    log("memory", f"decode step memory_analysis: {mem}")
    eng.generate_fused([prompt], max_new_tokens=8)  # compile + warm
    t0 = time.perf_counter()
    toks = eng.generate_fused([prompt], max_new_tokens=new_tokens)
    dt = time.perf_counter() - t0
    if toks.shape != (1, new_tokens) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"bad decode tokens {toks}")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log("memory", f"{cfg.n_layers}-layer {fmt}: prefill {len(prompt)} + decode "
        f"{new_tokens} tokens, batch 1, in {dt:.3f} s -> {new_tokens / dt:.1f} tok/s; "
        f"peak_bytes_in_use={peak}")
    return {"peak_bytes_in_use": peak, "tok_per_s": new_tokens / dt}


def _greedy(eng, prompts, n):
    """Greedy streams and the logits each token was chosen from."""
    import jax.numpy as jnp

    logits, cache = eng.prefill(prompts)
    toks, logs = [], []
    for _ in range(n):
        lg = np.asarray(logits, np.float32)[:, : eng.cfg.vocab_size]
        tok = lg.argmax(-1).astype(np.int32)
        toks.append(tok)
        logs.append(lg)
        logits, cache = eng.decode_step(jnp.asarray(tok), cache)
    return np.stack(toks, 1), np.stack(logs, 1)


def compare_streams(name, ref_toks, ref_logits, toks, logits, tol_rel: float) -> None:
    """Equal logits to `tol_rel` of the reference's largest |logit| at each
    step, and equal tokens up to a near tie: where the streams part, the
    reference must rate both tokens within that tolerance; the comparison
    stops there."""
    worst = 0.0
    for b in range(ref_toks.shape[0]):
        for i in range(ref_toks.shape[1]):
            scale = float(np.abs(ref_logits[b, i]).max())
            tol = tol_rel * scale
            d = float(np.abs(ref_logits[b, i] - logits[b, i]).max())
            worst = max(worst, d / scale)
            if d > tol:
                raise AssertionError(f"{name}: seq {b} step {i} max |dlogit| {d} > {tol}")
            if ref_toks[b, i] != toks[b, i]:
                gap = ref_logits[b, i, ref_toks[b, i]] - ref_logits[b, i, toks[b, i]]
                if gap > tol:
                    raise AssertionError(f"{name}: seq {b} step {i} token differs, gap {gap}")
                break
    log("four", f"ok   {name} matches one card: max |dlogit| {worst:.3g} of max "
        f"|logit| (tolerance {tol_rel}: bf16 partial sums reduced in another order)")


def four_phase(cfg: GemmaConfig, fmt: str = "q4_0", n_devices: int = 4,
               new_tokens: int = 6, tol_rel: float = 0.02) -> None:
    """TPEngine (shard_map) and GSPMD shard_params on a 1 x n mesh against
    one card, plus serve() over the TPEngine."""
    import jax

    from gemma_tpu.parallel import make_mesh, shard_cache, shard_params
    from gemma_tpu.parallel.shard_decode import TPEngine
    from gemma_tpu.runtime import Engine, EngineConfig, serve
    from gemma_tpu.runtime.scheduler import Request
    from gemma_tpu.testing import make_params

    if len(jax.devices()) < n_devices:
        raise AssertionError(f"need {n_devices} devices, have {len(jax.devices())}")
    host = make_params(cfg, fmt)
    prompts = [[2, 17, 300, 42, 7], [2, 5, 9, 1000, 123, 4, 88]]
    one = Engine(cfg, jax.device_put(host, jax.devices()[0]),
                 EngineConfig(max_seq_len=128, max_batch=2, donate_cache=False))
    ref_toks, ref_logits = _greedy(one, prompts, new_tokens)
    log("four", f"one card: tokens {ref_toks.tolist()}")

    mesh = make_mesh(1, n_devices, devices=jax.devices()[:n_devices])
    tp = TPEngine(cfg, host, mesh, max_seq_len=128, max_batch=2)
    toks, logits = _greedy(tp, prompts, new_tokens)
    log("four", f"TPEngine: tokens {toks.tolist()}")
    compare_streams("TPEngine", ref_toks, ref_logits, toks, logits, tol_rel)

    with mesh:
        gs = Engine(cfg, shard_params(host, mesh),
                    EngineConfig(max_seq_len=128, max_batch=2, donate_cache=False))
        logits0, cache = gs.prefill(prompts, shard_cache(gs.new_cache(2), cfg, mesh))
        toks, logs = [], []
        for _ in range(new_tokens):
            lg = np.asarray(logits0, np.float32)[:, : cfg.vocab_size]
            tok = lg.argmax(-1).astype(np.int32)
            toks.append(tok)
            logs.append(lg)
            logits0, cache = gs.decode_step(jax.numpy.asarray(tok), cache)
    toks, logs = np.stack(toks, 1), np.stack(logs, 1)
    log("four", f"GSPMD: tokens {toks.tolist()}")
    compare_streams("GSPMD shard_params", ref_toks, ref_logits, toks, logs, tol_rel)

    reqs = [Request(f"t{i}", p, max_new_tokens=4) for i, p in enumerate(prompts * 2)]
    sched = serve(tp, reqs, block=2)
    _check_tokens(sched, reqs, cfg.vocab_size)
    log("four", f"ok   serve() over TPEngine: {sched.stats()}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card tensor-parallel path")
    args = ap.parse_args(argv)

    from gemma_tpu.compile_cache import setup_compile_cache
    from gemma_tpu.models import GEMMA_2B, GEMMA_7B

    t_start = time.perf_counter()
    try:
        info = device_report()
    except NoGPU as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    setup_compile_cache()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(name, f"phase done in {time.perf_counter() - t0:.1f} s")
        return out

    if args.four:
        timed("four", four_phase, cut(GEMMA_7B, 2))
    else:
        timed("kernels", kernel_phase, default_matmul_cases(), default_attention_cases())
        timed("e2e", e2e_phase, cut(GEMMA_2B, E2E_LAYERS))
        with tempfile.TemporaryDirectory() as d:
            small = GemmaConfig(
                vocab_size=4096, d_model=512, n_layers=2, n_heads=4,
                n_kv_heads=1, head_dim=128, d_ff=1024, context_length=512,
            )
            timed("cli", cli_phase, small, d)
        timed("memory", memory_phase, GEMMA_2B)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
