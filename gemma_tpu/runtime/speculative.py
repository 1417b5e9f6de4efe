"""Prompt-lookup speculative decoding — fully on-device, async-chainable.

A serving capability the reference cannot express (it decodes strictly one
token per graph execution, /root/reference/src/gemma_model.cpp:548-575).
Batch-1 greedy decode streams EVERY weight byte to emit ONE token;
speculative decoding drafts k continuation candidates, verifies them in a
single (k+1)-position forward — which streams the weights ONCE — and emits
every accepted draft plus the correcting token. The output is EXACTLY the
greedy token stream (verification replays argmax), so this is a pure
throughput transform; gains scale with how repetitive the continuation is
(code, extraction, quoting — prompt-lookup needs no draft model).

Device-resident formulation: CPU implementations sync with the host every
step to run the n-gram lookup. Here the ENTIRE step — bigram lookup over the
on-device token history, (k+1)-token verification forward, acceptance,
cache-length rollback, history append — is one traced program, so steps
chain through the dispatch queue with zero host round-trips (the property
the plain decode path already exploits; at batch 1 a per-step sync can
cost more than the compute). The host drains
`(tokens [n, k+1], counts [n])` once per block and truncates.

Cache semantics: the verify forward writes K/V for all k+1 positions; the
accepted prefix advances `cache.length`, and the stale tail is simply
overwritten by the next step's writes at the new length (attention masks
`col < kv_limit`, so stale rows are never read).
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gemma


def get_decoder(engine, k: int = 7, block: int = 4) -> "SpecDecoder":
    """Engine-cached SpecDecoder: jitted programs live as long as the
    engine, so a fresh Scheduler (or repeated standalone use) re-uses the
    traced step instead of paying several seconds of host re-tracing per
    instance (the XLA binary cache only skips the compile, not the trace)."""
    cache = getattr(engine, "_spec_decoders", None)
    if cache is None:
        cache = engine._spec_decoders = {}
    key = (int(k), int(block))
    if key not in cache:
        cache[key] = SpecDecoder(engine, k=k, block=block)
    return cache[key]


class SpecDecoder:
    """Owns the jitted speculative block step for one Engine (B=1, greedy,
    dense cache)."""

    def __init__(self, engine, k: int = 7, block: int = 4):
        # default k=7: the verify forward is then T=8 rows, inside the 16
        # rows the quant-matmul kernel pads M to anyway, so a
        # fully-rejected verify streams the same weight bytes as one
        # decode step
        self.engine = engine
        self.k = int(k)
        self.block = int(block)
        if engine.ecfg.paged:
            raise ValueError("speculative decoding requires the dense cache")
        self._step = jax.jit(
            functools.partial(self._block_impl, n=self.block),
            donate_argnums=(2,) if engine.ecfg.donate_cache else (),
        )

    # -- in-graph pieces ---------------------------------------------------
    def _draft(self, history, hist_len, t_prev, t_cur):
        """Most-recent bigram match in history[:hist_len]; returns the k
        tokens following the match (junk when no match — they just fail
        verification). The trailing pair (t_prev, t_cur) itself sits at
        hist_len-2 and is excluded (its continuation is what we're
        predicting). history [L] i32."""
        L = history.shape[0]
        idx = jnp.arange(L, dtype=jnp.int32)
        nxt = jnp.roll(history, -1)
        match = (history == t_prev) & (nxt == t_cur) & (idx < hist_len - 2)
        p = jnp.max(jnp.where(match, idx, -1))
        start = jnp.clip(p + 2, 0, L - self.k)
        drafts = jax.lax.dynamic_slice(history, (start,), (self.k,))
        # no match: propose the current token repeated (still verified)
        return jnp.where(p >= 0, drafts, jnp.full((self.k,), t_cur))

    def _spec_step(self, params, carry):
        """One draft+verify step. carry = (t_cur, t_prev, cache, history,
        hist_len); emits (emitted [k+1], n_emitted) — first n valid."""
        eng = self.engine
        t_cur, t_prev, cache, history, hist_len = carry
        k = self.k
        drafts = self._draft(history, hist_len, t_prev, t_cur)
        toks = jnp.concatenate([t_cur[None], drafts]).astype(jnp.int32)
        length = cache.length  # [1]
        positions = length[:, None] + jnp.arange(k + 1, dtype=jnp.int32)[None, :]
        # SCALAR write_index (B=1): routes the KV write through the chunk
        # path (dynamic_update_slice of all k+1 rows). The [B]-vector form
        # takes write_token, which writes ONLY the first row — draft
        # positions would then attend stale K/V for their in-chunk
        # predecessors and mis-verify (and the scatter is slower anyway).
        logits, cache = gemma.forward(
            params, eng.cfg, toks[None, :], positions, cache,
            write_index=length[0], kv_limit=length + k + 1,
        )  # [1, k+1, vocab]
        g = jnp.argmax(logits[0], axis=-1).astype(jnp.int32)  # greedy at each pos
        # accept drafts while they reproduce greedy: draft_i == g_{i-1}
        acc = jnp.cumprod((drafts == g[:k]).astype(jnp.int32))
        a = jnp.sum(acc)  # accepted drafts in [0, k]
        # the emitted continuation [d_1..d_a, g_{a+1}] equals g[0..a]
        n_emit = a + 1
        cache = dataclasses.replace(cache, length=length + n_emit)
        history = jax.lax.dynamic_update_slice(history, g, (hist_len,))
        hist_len = hist_len + n_emit
        t_cur2 = g[a]  # the correcting token, next step's input
        t_prev2 = jnp.where(a > 0, g[a - 1], t_cur)
        return (t_cur2, t_prev2, cache, history, hist_len), g, n_emit

    def _block_impl(self, params, carry0, cache, *, n):
        t_cur, t_prev, history, hist_len = carry0
        carry = (t_cur, t_prev, cache, history, hist_len)
        packed = []
        for _ in range(n):
            carry, e, c = self._spec_step(params, carry)
            packed.append(jnp.concatenate([e, c[None]]))
        t_cur, t_prev, cache, history, hist_len = carry
        # ONE packed [n, k+2] output (tokens + count): the host drain is a
        # single device fetch, whose round-trip dwarfs the bytes moved
        return (
            (t_cur, t_prev, history, hist_len),
            jnp.stack(packed),  # [n, k+2]
            cache,
        )

    # -- batched step (continuous-batching scheduler) ----------------------
    # Every decode slot drafts/verifies simultaneously; per-seq lengths
    # diverge naturally (cache.length is already per-seq) and the verify
    # forward writes each slot's k+1 rows at its OWN length via
    # KVCache.write_chunk_per_seq (vector write_index + T>1 routing in
    # models/gemma.py).

    @functools.cached_property
    def _batch_step(self):
        return jax.jit(
            self._batch_step_impl,
            donate_argnums=(5,) if self.engine.ecfg.donate_cache else (),
        )

    @functools.cached_property
    def _batch_block(self):
        """n chained batched ticks in ONE dispatch, emitting a single packed
        [n, B, k+2] int32 output (tokens [k+1] columns + count). One host
        fetch per block instead of per tick: where a small device fetch
        costs more than the batched tick itself, per-tick drains, not the
        verify forwards, bound serving speculation."""
        def block(params, t_cur, t_prev, hist, hist_len, cache, *, n):
            packed = []
            for _ in range(n):
                t_cur, t_prev, hist, hist_len, g, n_emit, cache = (
                    self._batch_step_impl(params, t_cur, t_prev, hist, hist_len, cache)
                )
                packed.append(jnp.concatenate([g, n_emit[:, None]], axis=1))
            return t_cur, t_prev, hist, hist_len, jnp.stack(packed), cache

        return jax.jit(
            functools.partial(block, n=self.block),
            donate_argnums=(5,) if self.engine.ecfg.donate_cache else (),
        )

    def _batch_step_impl(self, params, t_cur, t_prev, hist, hist_len, cache):
        """t_cur/t_prev [B], hist [B, L], hist_len [B]. Returns
        (t_cur', t_prev', hist', hist_len', emitted [B, k+1], n_emit [B],
        cache)."""
        eng = self.engine
        k = self.k
        B = t_cur.shape[0]
        drafts = jax.vmap(self._draft)(hist, hist_len, t_prev, t_cur)  # [B, k]
        toks = jnp.concatenate([t_cur[:, None], drafts], axis=1).astype(jnp.int32)
        lengths = cache.length  # [B]
        verify = getattr(eng, "spec_verify", None)
        if verify is not None:
            # engine-provided verify forward (TPEngine: shard_mapped layers
            # + a logits all-gather; draft/acceptance stays replicated here)
            logits, cache = verify(params, toks, cache)
        else:
            positions = lengths[:, None] + jnp.arange(k + 1, dtype=jnp.int32)[None, :]
            logits, cache = gemma.forward(
                params, eng.cfg, toks, positions, cache,
                write_index=lengths, kv_limit=lengths + k + 1,
            )  # [B, k+1, vocab]
        g = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, k+1]
        acc = jnp.cumprod((drafts == g[:, :k]).astype(jnp.int32), axis=1)
        a = jnp.sum(acc, axis=1)  # [B]
        n_emit = a + 1
        cache = dataclasses.replace(cache, length=lengths + n_emit)
        hist = jax.vmap(
            lambda h, e, s: jax.lax.dynamic_update_slice(h, e, (s,))
        )(hist, g, hist_len)
        hist_len = hist_len + n_emit
        t_cur2 = jnp.take_along_axis(g, a[:, None], axis=1)[:, 0]
        prev_idx = jnp.maximum(a - 1, 0)[:, None]
        t_prev2 = jnp.where(
            a > 0, jnp.take_along_axis(g, prev_idx, axis=1)[:, 0], t_cur
        )
        return t_cur2, t_prev2, hist, hist_len, g, n_emit, cache

    # -- host driver -------------------------------------------------------
    def generate(self, prompt: list[int], max_new_tokens: int) -> list[int]:
        """Greedy generation, token-equal to Engine.generate_fused's greedy
        stream, emitting 1..k+1 tokens per verify forward. Returns exactly
        `max_new_tokens` tokens (no early EOS exit, like generate_fused)."""
        eng = self.engine
        S = eng.ecfg.max_seq_len
        # every step transiently writes k+1 rows past the current length;
        # the host pipelines up to TWO blocks in flight (the drain of one
        # block's counts overlaps the next block's compute — a per-block
        # sync could otherwise cost more than the verify forwards) and the
        # in-flight blocks can over-emit before
        # the host truncates. Worst case: prompt + max_new +
        # (2*block+1)*(k+1) rows (a clamped dynamic_update_slice would
        # silently corrupt earlier rows — hard precondition).
        overshoot = (2 * self.block + 1) * (self.k + 1)
        if len(prompt) + max_new_tokens + overshoot > S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"+ worst-case draft window ({overshoot}) "
                f"exceeds max_seq_len {S}"
            )
        logits, cache = eng.prefill([prompt])
        t0 = int(np.asarray(jnp.argmax(logits[0])))
        history = np.zeros(S + self.k + 2, np.int32)
        history[: len(prompt)] = prompt
        history[len(prompt)] = t0
        carry = (
            jnp.asarray(t0, jnp.int32),
            jnp.asarray(prompt[-1] if prompt else 0, jnp.int32),
            jnp.asarray(history),
            jnp.asarray(len(prompt) + 1, jnp.int32),
        )
        out: list[int] = [t0]
        self.steps = 0  # verify forwards issued (for accept-rate reporting)
        pending: collections.deque = collections.deque()

        def issue():
            nonlocal carry, cache
            carry, packed, cache = self._step(eng.params, carry, cache)
            self.steps += self.block
            pending.append(packed)

        def drain_one():
            p_np = np.asarray(pending.popleft())  # [n, k+2], one fetch
            for i in range(self.block):
                out.extend(int(t) for t in p_np[i, : int(p_np[i, -1])])

        while len(out) < max_new_tokens:
            if len(pending) < 2:
                issue()  # keep two blocks in flight: drain overlaps compute
            if len(pending) >= 2:
                drain_one()
        while pending:
            drain_one()
        return out[:max_new_tokens]
