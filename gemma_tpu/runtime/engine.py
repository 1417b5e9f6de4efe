"""Inference engine: jitted prefill/decode graphs + generation loops.

Counterpart of the reference's `begin_one_round_inference` /
`inference` driver (`/root/reference/src/gemma_model.cpp:231-286,548-575`).
Where the reference rebuilds and re-executes a ggml graph per token with a
single-threaded executor, this engine:

* traces ONE prefill graph per (batch, bucketed-length) and ONE fused
  sample+decode step graph per batch size; XLA compiles and caches them;
* donates the KV-cache through jit, so decode updates happen in place in
  device memory;
* drives generation as a **host-chained asynchronous dispatch pipeline**:
  every step is one device program whose inputs are the previous step's
  device arrays — the host never blocks on a token unless streaming or
  checking EOS (then only once per `eos_check_every` chunk), and chained
  dispatch keeps the device queue full (whether a device-side scan of
  steps does better on the GPU is open: tools/bench_scan.py measures it);
* supports greedy/temperature/top-k/top-p sampling and per-sequence EOS.

Prompt lengths are bucketed to powers of two to bound recompilation
(SURVEY.md §7 hard part (d)).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gemma
from ..models.config import GemmaConfig
from ..quant.qtensor import QTensor
from ..utils import profiling as prof
from .kv_cache import KVCache
from .sampler import SamplingParams, sample


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class EngineConfig:
    max_seq_len: int = 512
    max_batch: int = 1
    kv_dtype: Any = jnp.bfloat16
    kv_quantized: bool = False
    prefill_bucket_min: int = 16
    donate_cache: bool = True
    # tokens decoded per dispatched program in generate_fused: a fully
    # unrolled K-step block amortizes the fixed per-program dispatch cost
    # at the price of a longer first compile. 1 = one program per token.
    decode_block: int = 8
    # paged KV-cache (block tables over a shared page pool). One page is
    # one inner-loop block of the decode kernel (ops/attention.py), which
    # wants a power of two of at least 16 keys; 64 keys matches the dense
    # cache's block and keeps the allocation granularity small.
    paged: bool = False
    page_size: int = 64
    n_pages: int | None = None  # default: max_batch * max_seq_len / page_size
    # chunked prefill: prompts longer than this are prefilled in fixed
    # `prefill_chunk`-token pieces (one compiled shape regardless of prompt
    # length — an 8K prompt compiles the same program as a 1K one).
    # 0 disables. Must be a bucket-friendly power of two.
    prefill_chunk: int = 0


class Engine:
    """Owns compiled step functions for one model + one cache geometry."""

    def __init__(self, cfg: GemmaConfig, params, engine_cfg: EngineConfig | None = None):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg or EngineConfig()
        donate = self.ecfg.donate_cache
        self._prefill = jax.jit(self._prefill_impl, donate_argnums=(3,) if donate else ())
        self._decode = jax.jit(self._decode_impl, donate_argnums=(2,) if donate else ())
        # fused sample+decode: one dispatch per generated token
        self._step = jax.jit(
            self._step_impl,
            static_argnames=("sampling",),
            donate_argnums=(3,) if donate else (),
        )
        # unrolled K-token block: one dispatch per K tokens
        self._block = jax.jit(
            self._block_impl,
            static_argnames=("sampling", "n"),
            donate_argnums=(3,) if donate else (),
        )
        self._prefill_chunk = jax.jit(
            self._prefill_chunk_impl, donate_argnums=(4,) if donate else ()
        )

    @functools.cached_property
    def _weight_stats(self) -> tuple[int, int]:
        """(HBM bytes streamed per decode step, logical weight elements) —
        feeds the roofline ledger; decode streams every weight once."""
        nbytes = 0
        nelems = 0

        def visit(node):
            nonlocal nbytes, nelems
            if isinstance(node, QTensor):
                nbytes += node.nbytes()
                nelems += node.shape[0] * node.shape[1]
            elif hasattr(node, "shape") and hasattr(node, "dtype"):
                nbytes += int(np.prod(node.shape)) * node.dtype.itemsize
                nelems += int(np.prod(node.shape))
            elif isinstance(node, dict):
                for v in node.values():
                    visit(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    visit(v)

        visit(self.params)
        return nbytes, nelems

    def _record_decode_roofline(self, n_steps: int, batch: int, seconds: float) -> None:
        if not prof.is_enabled() or n_steps <= 0 or seconds <= 0:
            return
        nbytes, nelems = self._weight_stats
        prof.roofline(
            f"decode.steps[B={batch}]",
            seconds=seconds,
            bytes_moved=nbytes * n_steps,
            flops=2 * nelems * n_steps * batch,
        )
        prof.add_count("tokens.decoded", n_steps * batch)

    # -- cache -------------------------------------------------------------
    def new_cache(self, batch: int | None = None, *, identity_pages: bool = True):
        """`identity_pages` (paged mode only): give each slot a private page
        range so direct prefill/generate works out of the box. The scheduler
        passes False — it installs per-slot tables via the PageAllocator and
        needs inactive slots parked on the trash page (a fresh all-zeros
        table would otherwise alias pages the allocator hands out)."""
        batch = batch or self.ecfg.max_batch
        if self.ecfg.paged:
            from .paged_kv import PagedKVCache

            # +1: page 0 is the reserved trash page
            n_pages = self.ecfg.n_pages or (
                batch * self.ecfg.max_seq_len // self.ecfg.page_size + 1
            )
            return PagedKVCache.create(
                self.cfg, batch, n_pages,
                page_size=self.ecfg.page_size,
                max_seq_len=self.ecfg.max_seq_len,
                dtype=self.ecfg.kv_dtype,
                quantized=self.ecfg.kv_quantized,
                identity_layout=identity_pages,
            )
        return KVCache.create(
            self.cfg, batch, self.ecfg.max_seq_len,
            dtype=self.ecfg.kv_dtype,
            quantized=self.ecfg.kv_quantized,
        )

    # -- raw steps ---------------------------------------------------------
    def _prefill_impl(self, params, tokens, lengths, cache: KVCache):
        """tokens [B, T] (right-padded), lengths [B] true lengths.

        Returns (logits_at_last [B, vocab], cache)."""
        B, T = tokens.shape
        positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
        logits, cache = gemma.forward(
            params, self.cfg, tokens, positions, cache,
            write_index=jnp.asarray(0, jnp.int32), kv_limit=lengths,
            logits_at=lengths - 1,
        )
        cache = dataclasses.replace(cache, length=lengths)
        return logits[:, 0], cache

    def _decode_impl(self, params, tokens, cache: KVCache):
        """tokens [B] current tokens; appends one position per sequence."""
        B = tokens.shape[0]
        positions = cache.length[:, None]  # [B, 1] absolute position of new token
        logits, cache = gemma.forward(
            params, self.cfg, tokens[:, None], positions, cache,
            write_index=cache.length, kv_limit=cache.length + 1,
        )
        cache = cache.advance(1)
        return logits[:, 0], cache

    def _block_impl(self, params, logits, key, cache: KVCache, *, sampling: SamplingParams, n: int):
        """n fused sample+decode steps, unrolled into one program.
        Returns (tokens [B, n], next_logits, cache, next_key)."""
        toks = []
        for _ in range(n):
            tok, logits, cache, key = self._step_impl(
                params, logits, key, cache, sampling=sampling
            )
            toks.append(tok)
        return jnp.stack(toks, axis=1), logits, cache, key

    def _step_impl(self, params, logits, key, cache: KVCache, *, sampling: SamplingParams):
        """Sample from `logits`, then run one decode step with the sampled
        token. The PRNG key is split *inside* the step (greedy skips it
        entirely) so the host issues exactly ONE dispatch per token.
        Returns (token [B], next_logits [B, vocab], cache, next_key)."""
        if sampling.is_greedy:
            tok = sample(logits, sampling, None)
        else:
            key, sub = jax.random.split(key)
            tok = sample(logits, sampling, sub)
        next_logits, cache = self._decode_impl(params, tok, cache)
        return tok, next_logits, cache, key

    def _prefill_chunk_impl(self, params, tokens, start, kv_limit, cache, lengths, prev_last):
        """One fixed-shape chunk of a long prefill: tokens [B, C] at absolute
        positions [start, start+C). Carries the per-sequence last-token
        logits (selected in the chunk that contains lengths-1) so the host
        never syncs between chunks."""
        B, C = tokens.shape
        positions = start + jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, C))
        idx = jnp.clip(lengths - 1 - start, 0, C - 1)
        logits, cache = gemma.forward(
            params, self.cfg, tokens, positions, cache,
            write_index=start, kv_limit=kv_limit, logits_at=idx,
        )
        cache = dataclasses.replace(cache, length=kv_limit)
        in_chunk = (lengths - 1 >= start) & (lengths - 1 < start + C)
        last = jnp.where(in_chunk[:, None], logits[:, 0], prev_last)
        return last, cache

    # -- public API --------------------------------------------------------
    def prefill(self, prompts: list[list[int]], cache: KVCache | None = None):
        """Pad a batch of prompts to a bucket and run the prefill graph.
        Prompts longer than `prefill_chunk` (when set) run chunked: a fixed
        per-chunk compile shape regardless of prompt length."""
        B = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int32)
        maxlen = int(lengths.max())
        chunk = self.ecfg.prefill_chunk
        if chunk and maxlen > chunk:
            return self.prefill_chunked(prompts, chunk, cache)
        T = _bucket(maxlen, self.ecfg.prefill_bucket_min)
        toks = np.zeros((B, T), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        cache = cache if cache is not None else self.new_cache(B)
        with prof.span(f"prefill.dispatch[B={B},T={T}]"):
            out = self._prefill(self.params, jnp.asarray(toks), jnp.asarray(lengths), cache)
        prof.add_count("tokens.prefilled", int(lengths.sum()))
        return out

    def prefill_chunked(
        self, prompts: list[list[int]], chunk_size: int | None = None,
        cache: KVCache | None = None,
    ):
        """Prefill in fixed `chunk_size`-token pieces (SURVEY.md config 4:
        long prompts without per-length compiles). Prefill attention handles
        the offset query positions natively; chunk writes land at
        page-aligned offsets when the cache is paged (chunk_size must then
        be a page_size multiple). Returns (last_logits [B, vocab], cache)."""
        B = len(prompts)
        chunk = chunk_size or self.ecfg.prefill_chunk or 512
        if self.ecfg.paged and chunk % self.ecfg.page_size != 0:
            raise ValueError(
                f"prefill_chunk ({chunk}) must be a multiple of page_size "
                f"({self.ecfg.page_size})"
            )
        lengths = np.array([len(p) for p in prompts], np.int32)
        maxlen = int(lengths.max())
        n_chunks = -(-maxlen // chunk)
        toks = np.zeros((B, n_chunks * chunk), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        cache = cache if cache is not None else self.new_cache(B)
        lengths_d = jnp.asarray(lengths)
        last = jnp.zeros((B, self.cfg.vocab_size), jnp.float32)
        for c in range(n_chunks):
            start = c * chunk
            limit = np.minimum(lengths, start + chunk).astype(np.int32)
            with prof.span(f"prefill.chunk[B={B},C={chunk}]"):
                last, cache = self._prefill_chunk(
                    self.params,
                    jnp.asarray(toks[:, start : start + chunk]),
                    jnp.asarray(start, jnp.int32),
                    jnp.asarray(limit),
                    cache,
                    lengths_d,
                    last,
                )
        cache = dataclasses.replace(cache, length=lengths_d)
        prof.add_count("tokens.prefilled", int(lengths.sum()))
        return last, cache

    def decode_step(self, tokens: jax.Array, cache: KVCache):
        return self._decode(self.params, tokens, cache)

    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        """Prefill one sequence into a throwaway bucket-sized cache and
        return (logits [vocab], k_seq, v_seq, scales..., length) for
        insertion into a serving cache slot (prefill/decode disaggregation:
        the prefill graph never touches the decode batch). Long prompts
        chunk when `prefill_chunk` is set, so admission never compiles a
        prompt-length-sized program.

        `pad_to`: round the output T up to this multiple — the DECODE-side
        page size when the consuming cache is paged (the paged insert
        reshapes [.., T, ..] into whole pages; under disaggregation the
        prefill engine cannot know the decode engine's page geometry)."""
        T = _bucket(len(prompt), self.ecfg.prefill_bucket_min)
        if self.ecfg.paged:
            # a short prompt (T < page_size) would otherwise produce zero
            # pages and a failing reshape at insert
            ps = self.ecfg.page_size
            T = -(-T // ps) * ps
        if pad_to:
            T = -(-T // pad_to) * pad_to
        tmp = KVCache.create(
            self.cfg, 1, T, dtype=self.ecfg.kv_dtype, quantized=self.ecfg.kv_quantized
        )
        chunk = self.ecfg.prefill_chunk
        if chunk and len(prompt) > chunk:
            logits, tmp = self.prefill_chunked([prompt], chunk, cache=tmp)
        else:
            toks = np.zeros((1, T), np.int32)
            toks[0, : len(prompt)] = prompt
            logits, tmp = self._prefill(
                self.params, jnp.asarray(toks), jnp.asarray([len(prompt)], np.int32), tmp
            )
        k_seq, v_seq, scales = tmp.extract_seq(0)
        return logits[0], k_seq, v_seq, scales, len(prompt)

    def insert_sequence(self, cache, slot: int, prefill_out, pages: list[int] | None = None):
        """Insert prefill_standalone output into `slot` of a serving cache.
        For paged caches, `pages` are the physical pages the allocator
        assigned to this sequence (>= prefill_bucket/page_size of them)."""
        logits, k_seq, v_seq, (k_sc, v_sc), length = prefill_out
        if pages is not None:
            maxp = cache.page_table.shape[1]
            pages_arr = np.zeros(maxp, np.int32)
            pages_arr[: len(pages)] = pages
            return self._insert_paged(
                cache, jnp.asarray(slot, jnp.int32), jnp.asarray(pages_arr),
                jnp.asarray(len(pages), jnp.int32), k_seq, v_seq,
                jnp.asarray(length, jnp.int32), k_sc, v_sc,
            )
        S = cache.max_len
        T = k_seq.shape[2]  # k_seq is [L, H, T, D]
        if T < S:  # pad the inserted chunk to a fixed shape per bucket
            pad = [(0, 0), (0, 0), (0, S - T), (0, 0)]
            k_seq = jnp.pad(k_seq, pad)
            v_seq = jnp.pad(v_seq, pad)
            if k_sc is not None:
                k_sc = jnp.pad(k_sc, pad[:3])
                v_sc = jnp.pad(v_sc, pad[:3])
        elif T > S:
            raise ValueError(f"prefill bucket {T} exceeds cache capacity {S}")
        return self._insert(
            cache, jnp.asarray(slot, jnp.int32), k_seq, v_seq,
            jnp.asarray(length, jnp.int32), k_sc, v_sc,
        )

    @functools.cached_property
    def _insert(self):
        def fn(cache, slot, k_seq, v_seq, length, k_sc, v_sc):
            return cache.insert_sequence(slot, k_seq, v_seq, length, k_sc, v_sc)

        return jax.jit(fn, donate_argnums=(0,) if self.ecfg.donate_cache else ())

    @functools.cached_property
    def _insert_paged(self):
        def fn(cache, slot, pages, n_used, k_seq, v_seq, length, k_sc, v_sc):
            return cache.insert_sequence(
                slot, pages, n_used, k_seq, v_seq, length, k_sc, v_sc
            )

        return jax.jit(fn, donate_argnums=(0,) if self.ecfg.donate_cache else ())

    def capture_activations(self, prompt: list[int], patterns=("*",)):
        """Golden-diff hook: run one un-jitted prefill while capturing named
        activations (utils.tensor_dump). Returns (logits, {name: array}).
        Computes the FULL [T, vocab] logits (logits_at=None), since golden
        diffs compare every position against the reference."""
        from ..utils import tensor_dump

        T = _bucket(len(prompt), self.ecfg.prefill_bucket_min)
        toks = np.zeros((1, T), np.int32)
        toks[0, : len(prompt)] = prompt
        positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (1, T))
        with tensor_dump.capture(patterns) as cap:
            logits, _ = gemma.forward(
                self.params, self.cfg, jnp.asarray(toks), positions,
                self.new_cache(1), write_index=jnp.asarray(0, jnp.int32),
                kv_limit=jnp.asarray([len(prompt)], jnp.int32),
            )
        return np.asarray(logits[0]), cap.values

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int | None = None,
        seed: int = 0,
        on_token: Callable[[int, list[int]], None] | None = None,
        eos_check_every: int = 8,
    ) -> list[list[int]]:
        """Generate with per-sequence EOS stopping.

        Dispatches the fused step asynchronously; syncs with the host only
        every `eos_check_every` tokens (or every token when streaming via
        `on_token`)."""
        B = len(prompts)
        if max_new_tokens <= 0:
            return [[] for _ in range(B)]
        logits, cache = self.prefill(prompts)
        return self.generate_from(
            logits, cache, max_new_tokens,
            sampling=sampling, eos_id=eos_id, seed=seed, on_token=on_token,
            eos_check_every=eos_check_every,
        )

    def generate_from(
        self,
        logits: jax.Array,
        cache: KVCache,
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int | None = None,
        seed: int = 0,
        on_token: Callable[[int, list[int]], None] | None = None,
        eos_check_every: int = 8,
    ) -> list[list[int]]:
        """Decode from already-prefilled (logits, cache) — lets callers time
        prefill (TTFT) and decode separately, as the reference reports them
        (gemma_model.cpp:566-572)."""
        B = logits.shape[0]
        # each decode step writes the incoming token's K/V at index `length`,
        # so exactly max_seq_len - prompt_len steps fit; one more would write
        # at index max_seq_len, which scatter silently drops and the step's
        # logits would miss the token's own K/V.
        prompt_len = int(np.asarray(cache.length).max())
        budget = min(max_new_tokens, self.ecfg.max_seq_len - prompt_len)
        key = jax.random.PRNGKey(seed)
        device_toks: list[jax.Array] = []
        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        emitted = 0

        def drain() -> bool:
            """Pull pending tokens to host; returns True when all sequences hit EOS."""
            nonlocal emitted
            for t in device_toks[emitted:]:
                t_np = np.asarray(t)
                for b in range(B):
                    if not done[b]:
                        out[b].append(int(t_np[b]))
                        if eos_id is not None and t_np[b] == eos_id:
                            done[b] = True
                if on_token is not None:
                    on_token(emitted, [int(v) for v in t_np])
                emitted += 1
                if done.all():
                    return True
            return done.all()

        check_every = 1 if on_token is not None else max(1, eos_check_every)
        sync_k = prof.sync_every()  # profiled runs: make spans device-honest
        t_dec = time.perf_counter()
        for i in range(budget):
            with prof.span("decode.dispatch"):
                tok, logits, cache, key = self._step(
                    self.params, logits, key, cache, sampling=sampling
                )
                if sync_k and i % sync_k == sync_k - 1:
                    jax.block_until_ready(tok)
            device_toks.append(tok)
            if eos_id is not None and (i + 1) % check_every == 0:
                if drain():
                    break
        drain()  # np.asarray inside forces device sync -> wall time is real
        self._record_decode_roofline(emitted, B, time.perf_counter() - t_dec)
        return out

    def generate_fused(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int | None = None,
        seed: int = 0,
    ) -> np.ndarray:
        """Throughput path: chain all steps with zero host syncs, fetch the
        [B, max_new_tokens] token matrix once at the end (no early EOS exit).
        Steps are dispatched in unrolled `decode_block`-token programs."""
        logits, cache = self.prefill(prompts)
        prompt_len = int(np.asarray(cache.length).max())
        if max_new_tokens > self.ecfg.max_seq_len - prompt_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds cache capacity "
                f"({self.ecfg.max_seq_len} - prompt {prompt_len})"
            )
        key = jax.random.PRNGKey(seed)
        block = max(1, self.ecfg.decode_block)
        chunks = []
        remaining = max_new_tokens
        sync_k = prof.sync_every()  # profiled runs: make spans device-honest
        i = 0
        t_dec = time.perf_counter()
        while remaining > 0:
            n = min(block, remaining)
            with prof.span(f"decode.block[n={n}]"):
                tb, logits, cache, key = self._block(
                    self.params, logits, key, cache, sampling=sampling, n=n
                )
                if sync_k and i % sync_k == sync_k - 1:
                    jax.block_until_ready(tb)
            chunks.append(tb)
            remaining -= n
            i += 1
        # concat on device; ONE host transfer at the end (a per-token fetch
        # pays a host round-trip per token)
        toks = np.asarray(jnp.concatenate(chunks, axis=1))
        self._record_decode_roofline(
            max_new_tokens, len(prompts), time.perf_counter() - t_dec
        )
        return toks
