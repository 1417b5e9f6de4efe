"""Continuous batching scheduler.

The reference serves exactly one hardcoded prompt per process
(`begin_one_round_inference`, gemma_model.cpp:548-575). This scheduler turns
the engine into a multi-request server: a fixed pool of decode slots shares
one batched KV-cache; requests are admitted into free slots via
prefill→insert (prefill runs standalone, batch-1, and never stalls running
decodes' graph shapes), every tick runs ONE fused decode step for all slots,
and finished sequences free their slot immediately for the next queued
request — decode batch occupancy stays high regardless of arrival order.

Tracks per-request TTFT (time to first token) and emission times for the
p50-TTFT metric mandated by BASELINE.json.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .engine import Engine
from .sampler import SamplingParams


@dataclasses.dataclass
class _Admission:
    """An in-flight chunked admission prefill (overlapped admission): the
    slot is reserved, the prompt prefills one `prefill_chunk` piece per
    decode tick, and the request activates when the last chunk lands —
    decode ticks between chunks keep running, so admitting a long prompt
    never stalls the batch for more than one chunk."""

    req: "Request"
    slot: int
    pages: list[int] | None
    toks: np.ndarray  # [1, n_chunks * chunk] right-padded prompt
    lengths: jax.Array  # [1] true prompt length (device)
    cache: object  # throwaway bucket-sized KVCache being filled
    last: jax.Array  # [1, vocab] carried last-token logits
    next_chunk: int
    n_chunks: int


@dataclasses.dataclass
class Request:
    id: str
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    # filled by the scheduler:
    tokens: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None
    slot: int | None = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def ttft(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class Scheduler:
    def __init__(
        self,
        engine: Engine,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        on_token: Callable[[Request, int], None] | None = None,
        prefill_engine: Engine | None = None,
        admit_per_tick: int | None = None,
        overlap_admission: bool = True,
        speculative: bool = False,
        spec_k: int = 7,
        spec_pipeline: int = 2,
        spec_block: int = 4,
        spec_min_accept: float = 2.5,
    ):
        """`prefill_engine` (optional) runs admission prefills on a different
        engine than the decode batch — prefill/decode disaggregation: the
        prefill side is compute-bound and bursty, the decode side latency-
        bound; its output transfers into the decode cache via
        `insert_sequence` (multihost.HostRoles picks which engine lives on
        which host).

        `admit_per_tick` caps admissions per decode tick: admission prefills
        run synchronously inside the tick, so an unbounded burst (None) of N
        free slots runs N prefills back-to-back before the batch decodes its
        next token — capping trades a little occupancy ramp for first-token
        latency of already-running requests.

        `overlap_admission` (with the prefill engine's `prefill_chunk` set):
        prompts longer than one chunk admit INCREMENTALLY — one prefill
        chunk per decode tick, decode blocks running between chunks — so a
        long admission stalls the running batch by at most one chunk's
        latency instead of a full-prompt prefill (VERDICT r3 weak #5).

        `speculative` (greedy sampling + dense cache only): every tick
        drafts `spec_k` tokens per slot from its token history and
        verifies them in one batched multi-position forward — each slot
        emits 1..spec_k+1 tokens per tick for one weight-stream pass
        (runtime/speculative.py), with the exact greedy token streams.

        `spec_pipeline`: speculative ticks kept in flight before the host
        drains one — the drain's device sync then overlaps the next tick's
        compute (the standalone driver's double-buffering, speculative.py
        generate). Finish decisions lag by the pipeline depth, so finished
        slots may decode a few discarded ticks (same trade as step_block);
        the emitted streams are unchanged. 1 = synchronous ticks.

        `spec_block`: batched verify ticks chained per dispatch, drained
        with ONE packed host fetch: where the fetch of a tick's (tokens,
        counts) costs more than the tick's compute, per-tick drains make
        serving speculation SLOWER than plain decode; blockifying restores
        it (same trade as step_block: admissions/finishes every block).

        `spec_min_accept`: ADAPTIVE speculation — a zero-acceptance verify
        at spec_k=7 costs several plain steps per emitted token, so when
        the rolling per-slot acceptance of
        k=7 blocks falls below this break-even the scheduler switches to a
        k=1 decoder (its T=2 verify rides the SAME M=8 matmul bucket as
        plain decode — draft-hostile content then decodes at ≈ the plain
        rate instead of 0.44x) and re-probes with one k=7 block every few
        blocks to recover when the content turns repetitive again. Both
        decoders share the cache/history state, so switching is free.
        Set <= 1 to pin k=spec_k unconditionally."""
        self.engine = engine
        self.prefill_engine = prefill_engine or engine
        if prefill_engine is not None:
            pe, de = prefill_engine.ecfg, engine.ecfg
            # the KV handoff (prefill tmp cache -> decode cache insert) is
            # only well-formed when both sides agree on the cache value
            # format; bucket shapes / chunking / max_seq_len may differ
            if (pe.kv_quantized, pe.kv_dtype) != (de.kv_quantized, de.kv_dtype):
                raise ValueError(
                    "disaggregated prefill engine must match the decode "
                    f"engine's KV format (prefill kv_quantized={pe.kv_quantized} "
                    f"dtype={pe.kv_dtype}; decode kv_quantized={de.kv_quantized} "
                    f"dtype={de.kv_dtype})"
                )
        self.admit_per_tick = admit_per_tick
        self.overlap_admission = overlap_admission
        self._admitting: dict[int, _Admission] = {}  # slot -> in-flight
        self._admit_order: collections.deque[int] = collections.deque()
        self.sampling = sampling
        self.on_token = on_token
        self.max_batch = engine.ecfg.max_batch
        # trash-page layout: every slot parks on page 0 until admission
        # installs its allocator-assigned table (identity layout would alias
        # the allocator's free pages)
        self.cache = engine.new_cache(self.max_batch, identity_pages=False)
        if hasattr(engine, "place_cache"):  # sharded engines (TPEngine)
            self.cache = engine.place_cache(self.cache)
        self.allocator = None
        self._slot_pages: dict[int, list[int]] = {}
        if engine.ecfg.paged:
            from .paged_kv import PageAllocator

            self.allocator = PageAllocator(self.cache.n_pages)
        self.pending: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.finished: list[Request] = []
        self.key = jax.random.PRNGKey(seed)
        self.spec = None
        if speculative:
            if not sampling.is_greedy:
                raise ValueError("speculative scheduling requires greedy sampling")
            if engine.ecfg.paged:
                raise ValueError("speculative scheduling requires the dense cache")
            from .speculative import get_decoder

            self.spec = get_decoder(engine, k=spec_k, block=max(1, int(spec_block)))
            self._spec_depth = max(1, int(spec_pipeline))
            self._spec_pending: collections.deque = collections.deque()
            self._spec_min_accept = float(spec_min_accept)
            self._spec_lo = (
                get_decoder(engine, k=1, block=max(1, int(spec_block)))
                if spec_k > 1 and self._spec_min_accept > 1
                else None
            )
            self._accept_ema = float(spec_k + 1)  # optimistic start
            self._spec_probe_every = 8
            self._lo_blocks_since_probe = 0
            L = engine.ecfg.max_seq_len + spec_k + 2
            self._sp_carry = (
                jnp.zeros(self.max_batch, jnp.int32),
                jnp.zeros(self.max_batch, jnp.int32),
                jnp.zeros((self.max_batch, L), jnp.int32),
                jnp.zeros(self.max_batch, jnp.int32),
            )
        # pipelined plain-block state (run(block) keeps 2 blocks in flight)
        self._plain_pending: collections.deque = collections.deque()
        self._plain_depth = 2
        # per-slot next-token logits, merged into one [B, vocab] batch
        self._logits = jnp.zeros((self.max_batch, engine.cfg.vocab_size), jnp.float32)
        self._steps = 0
        self._tokens_discarded = 0
        self._spec_forwards = 0

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = time.monotonic()
        self.pending.append(req)

    def _free_slots(self) -> list[int]:
        return [
            b for b in range(self.max_batch)
            if b not in self.active and b not in self._admitting
        ]

    def _admit(self) -> None:
        admitted = 0
        for slot in self._free_slots():
            if not self.pending:
                break
            if self.admit_per_tick is not None and admitted >= self.admit_per_tick:
                break
            req = self.pending.popleft()
            if len(req.prompt) >= self.engine.ecfg.max_seq_len:
                req.tokens = []
                req.finished_at = time.monotonic()
                self.finished.append(req)
                continue
            pages = None
            if self.allocator is not None:
                ps = self.cache.page_size
                need = max(
                    self._prefill_T(len(req.prompt)) // ps,
                    -(-(len(req.prompt) + req.max_new_tokens) // ps),
                )
                pages = self.allocator.allocate(need)
                if pages is None:
                    if not self.active and self.allocator.free_pages == self.allocator.n_pages - 1:
                        # nothing running and the FULL pool is still too
                        # small: this request can never be served
                        req.tokens = []
                        req.finished_at = time.monotonic()
                        self.finished.append(req)
                        continue
                    # pool exhausted: wait for a running request to finish
                    self.pending.appendleft(req)
                    break
                self._slot_pages[slot] = pages
            chunk = self.prefill_engine.ecfg.prefill_chunk
            # overlap only when it buys something: a <= 2-chunk prompt
            # synchronously stalls the batch by no more than the overlap
            # path's own per-tick chunk budget, while admitting through the
            # chunk queue would cut its admission rate (every chunk waits
            # for a tick of its own)
            if self.overlap_admission and chunk and len(req.prompt) > 2 * chunk:
                self._start_admission(req, slot, pages)
            else:
                pre = self.prefill_engine.prefill_standalone(
                    req.prompt,
                    pad_to=self.engine.ecfg.page_size if self.engine.ecfg.paged else None,
                )
                self.cache = self.engine.insert_sequence(self.cache, slot, pre, pages)
                self._logits = self._logits.at[slot].set(pre[0])
                req.slot = slot
                self.active[slot] = req
                if self.spec is not None:
                    self._seed_spec_slot(slot, req, pre[0])
            admitted += 1

    def _prefill_T(self, prompt_len: int) -> int:
        """Predict the padded KV length the admission prefill will insert —
        the PREFILL engine's bucketing (or chunking), rounded up to the
        DECODE engine's page size when the decode cache is paged. Sizes the
        page allocation so disaggregated prefill engines with different
        bucket geometry never overrun their pages."""
        from .engine import _bucket

        pe = self.prefill_engine.ecfg
        chunk = pe.prefill_chunk
        if self.overlap_admission and chunk and prompt_len > chunk:
            T = -(-prompt_len // chunk) * chunk
        else:
            T = _bucket(prompt_len, pe.prefill_bucket_min)
            if pe.paged:
                T = -(-T // pe.page_size) * pe.page_size
        if self.engine.ecfg.paged:
            ps = self.engine.ecfg.page_size
            T = -(-T // ps) * ps
        return T

    # -- overlapped (chunked) admission ------------------------------------
    def _start_admission(self, req: Request, slot: int, pages) -> None:
        from .kv_cache import KVCache

        eng = self.prefill_engine
        chunk = eng.ecfg.prefill_chunk
        L = len(req.prompt)
        n_chunks = -(-L // chunk)
        T = n_chunks * chunk
        if self.engine.ecfg.paged:
            # paged insert needs whole decode-side pages; chunk writes land
            # at dense offsets so padding the tmp cache up is free
            ps = self.engine.ecfg.page_size
            T = -(-T // ps) * ps
        tmp = KVCache.create(
            eng.cfg, 1, T, dtype=eng.ecfg.kv_dtype, quantized=eng.ecfg.kv_quantized
        )
        toks = np.zeros((1, T), np.int32)
        toks[0, :L] = req.prompt
        self._admitting[slot] = _Admission(
            req=req, slot=slot, pages=pages, toks=toks,
            lengths=jnp.asarray([L], jnp.int32), cache=tmp,
            last=jnp.zeros((1, eng.cfg.vocab_size), jnp.float32),
            next_chunk=0, n_chunks=n_chunks,
        )
        self._admit_order.append(slot)

    def _advance_admissions(self) -> None:
        """Run prefill chunks of the oldest in-flight admission; on its
        last chunk, insert into the decode cache and activate the request.
        Per decode tick the stall budget is ONE chunk — except when no
        request is decoding at all (empty batch): then there is nothing to
        stall, and chunks run back-to-back until an admission completes."""
        while self._admit_order:
            self._advance_one()
            if self.active or not self._admit_order:
                break

    def _advance_one(self) -> None:
        slot = self._admit_order[0]
        st = self._admitting[slot]
        eng = self.prefill_engine
        chunk = eng.ecfg.prefill_chunk
        s = st.next_chunk * chunk
        L = len(st.req.prompt)
        limit = min(L, s + chunk)
        st.last, st.cache = eng._prefill_chunk(
            eng.params,
            jnp.asarray(st.toks[:, s : s + chunk]),
            jnp.asarray(s, jnp.int32),
            jnp.asarray([limit], jnp.int32),
            st.cache,
            st.lengths,
            st.last,
        )
        st.next_chunk += 1
        if st.next_chunk < st.n_chunks:
            return
        # final chunk landed: assemble the insert tuple (prefill_standalone
        # output shape) and activate
        tmp = st.cache
        k_seq, v_seq, scales = tmp.extract_seq(0)
        pre = (st.last[0], k_seq, v_seq, scales, L)
        self.cache = self.engine.insert_sequence(self.cache, slot, pre, st.pages)
        self._logits = self._logits.at[slot].set(pre[0])
        st.req.slot = slot
        self.active[slot] = st.req
        if self.spec is not None:
            self._seed_spec_slot(slot, st.req, pre[0])
        self._admit_order.popleft()
        del self._admitting[slot]

    # -- speculative tick --------------------------------------------------
    def _seed_spec_slot(self, slot: int, req: Request, logits0) -> None:
        """Seed a freshly admitted slot's speculative state: its history
        row = prompt + first greedy token; the first token is emitted here
        (the plain path samples it on the next tick — same stream)."""
        t0 = int(np.asarray(jnp.argmax(logits0)))
        tc, tp, hist, hlen = self._sp_carry
        P = len(req.prompt)
        row = np.zeros(hist.shape[1], np.int32)
        row[:P] = req.prompt
        row[P] = t0
        self._sp_carry = (
            tc.at[slot].set(t0),
            tp.at[slot].set(req.prompt[-1] if req.prompt else 0),
            hist.at[slot].set(jnp.asarray(row)),
            hlen.at[slot].set(P + 1),
        )
        now = time.monotonic()
        req.first_token_at = now
        req.tokens.append(t0)
        if self.on_token is not None:
            self.on_token(req, t0)
        if (req.eos_id is not None and t0 == req.eos_id) or req.max_new_tokens <= 1:
            self._finish(slot, req, now)

    def _spec_full_limit(self) -> int:
        # active slots must always have write headroom: every in-flight tick
        # writes k+1 rows past the slot's length, and with a `_spec_depth`
        # pipeline of `block`-tick dispatches up to depth*block ticks land
        # before the host can stop the slot (the per-seq chunk write clamps
        # rather than overflows, and a clamp on an ACTIVE slot would corrupt
        # its valid rows)
        return self.engine.ecfg.max_seq_len - (
            self._spec_depth * self.spec.block + 1
        ) * (self.spec.k + 1)

    def _pick_spec_decoder(self):
        """Adaptive k (see __init__ doc): the hi decoder while rolling
        acceptance clears break-even; the k=1 decoder otherwise, with a
        periodic hi probe to detect recovery."""
        if self._spec_lo is None or self._accept_ema >= self._spec_min_accept:
            self._lo_blocks_since_probe = 0
            return self.spec, True
        self._lo_blocks_since_probe += 1
        if self._lo_blocks_since_probe >= self._spec_probe_every:
            self._lo_blocks_since_probe = 0
            return self.spec, True  # probe
        return self._spec_lo, False

    def _spec_issue(self) -> bool:
        """Admit, then dispatch one BLOCK of chained batched speculative
        ticks WITHOUT a host sync; the packed [n, B, k+2] device handle
        queues in _spec_pending with a snapshot of which request occupied
        each slot at issue time."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return False
        dec, is_hi = self._pick_spec_decoder()
        tc, tp, hist, hlen = self._sp_carry
        tc, tp, hist, hlen, packed, self.cache = dec._batch_block(
            self.engine.params, tc, tp, hist, hlen, self.cache
        )
        self._sp_carry = (tc, tp, hist, hlen)
        self._steps += dec.block
        self._spec_forwards += dec.block
        self._spec_pending.append((packed, is_hi, list(self.active.items())))
        return True

    def _spec_drain(self) -> list[tuple[str, int]]:
        """Sync the oldest in-flight block (ONE packed fetch) and emit its
        ticks' tokens in order. Requests that finished in an earlier drain
        or earlier tick of this block (pipeline/block lag) discard rows."""
        packed, is_hi, snapshot = self._spec_pending.popleft()
        p_np = np.asarray(packed)  # [n, B, k+2]
        k1 = p_np.shape[2] - 1
        if is_hi and snapshot:
            # rolling per-slot tokens/verify of hi-k blocks only (a k=1
            # block tops out at 2 and says nothing about hi-k viability)
            live = [slot for slot, req in snapshot if not req.done]
            if live:
                acc = float(p_np[:, live, k1].mean())
                self._accept_ema = 0.5 * self._accept_ema + 0.5 * acc
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        full_limit = self._spec_full_limit()
        for i in range(p_np.shape[0]):
            for slot, req in snapshot:
                c = int(p_np[i, slot, k1])
                if req.done:
                    self._tokens_discarded += c
                    continue
                for j in range(c):
                    t = int(p_np[i, slot, j])
                    req.tokens.append(t)
                    emitted.append((req.id, t))
                    if self.on_token is not None:
                        self.on_token(req, t)
                    hit_eos = req.eos_id is not None and t == req.eos_id
                    full = len(req.prompt) + len(req.tokens) >= full_limit
                    if hit_eos or full or len(req.tokens) >= req.max_new_tokens:
                        self._finish(slot, req, now)
                        self._tokens_discarded += c - 1 - j
                        break
        return emitted

    def step_spec(self) -> list[tuple[str, int]]:
        """One SYNCHRONOUS speculative block: every active slot drafts
        spec_k tokens per tick and verifies them in one shared forward,
        `spec_block` ticks chained per dispatch — each slot emits
        1..spec_block*(spec_k+1) tokens, exact greedy streams.
        (Scheduler.run pipelines `_spec_depth` blocks instead.)"""
        if not self._spec_issue():
            return []
        return self._spec_drain()

    # -- one decode tick ---------------------------------------------------
    def step(self) -> list[tuple[str, int]]:
        """Admit pending requests, run one batched decode step, emit one
        token per active request. Returns [(request_id, token)] emitted."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return []
        tok, self._logits, self.cache, self.key = self.engine._step(
            self.engine.params, self._logits, self.key, self.cache, sampling=self.sampling
        )
        tok_np = np.asarray(tok)
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        self._steps += 1

        for slot, req in list(self.active.items()):
            t = int(tok_np[slot])
            if req.first_token_at is None:
                req.first_token_at = now
            req.tokens.append(t)
            emitted.append((req.id, t))
            if self.on_token is not None:
                self.on_token(req, t)
            hit_eos = req.eos_id is not None and t == req.eos_id
            full = len(req.prompt) + len(req.tokens) >= self.engine.ecfg.max_seq_len
            if hit_eos or full or len(req.tokens) >= req.max_new_tokens:
                self._finish(slot, req, now)
        return emitted

    def step_block(self, n: int) -> list[tuple[str, int]]:
        """Admit, then run `n` fused decode steps with ONE host sync at the
        end (the engine's unrolled block program). Amortizes the per-dispatch
        host round-trip, which can cost more than the decode compute itself
        at small batch. Trade-off: slots are
        only freed (and new requests admitted) every `n` tokens, and a
        sequence hitting EOS mid-block decodes a few discarded tokens (their
        cache writes land in its own slot, which is reset on re-admission).
        """
        self._advance_admissions()
        self._admit()
        if not self.active:
            return []
        tb, self._logits, self.cache, self.key = self.engine._block(
            self.engine.params, self._logits, self.key, self.cache,
            sampling=self.sampling, n=n,
        )
        tok_np = np.asarray(tb)  # [B, n]
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        for slot, req in list(self.active.items()):
            for j in range(n):
                t = int(tok_np[slot, j])
                if req.first_token_at is None:
                    req.first_token_at = now
                req.tokens.append(t)
                emitted.append((req.id, t))
                if self.on_token is not None:
                    self.on_token(req, t)
                hit_eos = req.eos_id is not None and t == req.eos_id
                full = len(req.prompt) + len(req.tokens) >= self.engine.ecfg.max_seq_len
                if hit_eos or full or len(req.tokens) >= req.max_new_tokens:
                    self._finish(slot, req, now)
                    # the remaining n-1-j tokens of this slot's block were
                    # decoded by the device but never emitted
                    self._tokens_discarded += n - 1 - j
                    break
        # decode_steps counts device steps (consistent with per-token mode:
        # one batched step per tick); the wasted tail work of finished slots
        # is visible separately as tokens_discarded.
        self._steps += n
        return emitted

    # -- pipelined plain blocks (run(block) drives these) ------------------
    def _plain_issue(self, n: int) -> bool:
        """Dispatch one fused decode block WITHOUT a host sync. The [B, n]
        token fetch is a host round-trip, so run() keeps two blocks in
        flight and each drain overlaps the next block's compute."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return False
        tb, self._logits, self.cache, self.key = self.engine._block(
            self.engine.params, self._logits, self.key, self.cache,
            sampling=self.sampling, n=n,
        )
        self._steps += n
        self._plain_pending.append((tb, n, list(self.active.items())))
        return True

    def _plain_drain(self) -> list[tuple[str, int]]:
        tb, n, snapshot = self._plain_pending.popleft()
        tok_np = np.asarray(tb)  # [B, n]
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        for slot, req in snapshot:
            if req.done:
                self._tokens_discarded += n
                continue
            for j in range(n):
                t = int(tok_np[slot, j])
                if req.first_token_at is None:
                    req.first_token_at = now
                req.tokens.append(t)
                emitted.append((req.id, t))
                if self.on_token is not None:
                    self.on_token(req, t)
                hit_eos = req.eos_id is not None and t == req.eos_id
                # finish decisions lag by the pipeline depth: keep
                # depth*n rows of write headroom so in-flight blocks of a
                # full slot never write past capacity
                full = len(req.prompt) + len(req.tokens) >= (
                    self.engine.ecfg.max_seq_len - self._plain_depth * n
                )
                if hit_eos or full or len(req.tokens) >= req.max_new_tokens:
                    self._finish(slot, req, now)
                    self._tokens_discarded += n - 1 - j
                    break
        return emitted

    def _finish(self, slot: int, req: Request, now: float) -> None:
        req.finished_at = now
        self.finished.append(req)
        del self.active[slot]  # slot freed; cache row overwritten on admit
        if self.allocator is not None and slot in self._slot_pages:
            # stale decode writes of this slot must not touch pages that get
            # re-allocated: retarget its table to the trash page first
            self.cache = dataclasses.replace(
                self.cache,
                page_table=self.cache.page_table.at[slot].set(0),
                length=self.cache.length.at[slot].set(0),
            )
            self.allocator.release(self._slot_pages.pop(slot))

    def run(self, max_steps: int | None = None, block: int = 1) -> list[Request]:
        """Drive until all submitted work completes; returns finished reqs.
        `block` > 1 decodes in fused multi-token blocks (see step_block).
        `max_steps` bounds device decode steps (a block tick counts as
        `block` steps), so the work cap is block-size independent."""
        steps = 0
        if self.spec is not None:
            # pipelined speculative loop: keep `_spec_depth` ticks in
            # flight; each drain's host sync overlaps the next tick's
            # verify forward (the standalone driver's double-buffering,
            # speculative.py generate — a per-tick sync pays the full
            # host<->device round-trip otherwise)
            while (self.pending or self.active or self._admitting) and (
                max_steps is None or steps < max_steps
            ):
                issued = False
                if len(self._spec_pending) < self._spec_depth:
                    issued = self._spec_issue()
                    if issued:
                        steps += self.spec.block
                if self._spec_pending and (
                    not issued or len(self._spec_pending) >= self._spec_depth
                ):
                    self._spec_drain()
                elif not issued:
                    break  # nothing issuable or pending: avoid spinning
            while self._spec_pending:
                self._spec_drain()
            return self.finished
        if block > 1:
            # pipelined fused blocks: the ~46 ms remote token fetch of one
            # block overlaps the next block's decode (see _plain_issue)
            while (self.pending or self.active or self._admitting) and (
                max_steps is None or steps < max_steps
            ):
                issued = False
                if len(self._plain_pending) < self._plain_depth:
                    issued = self._plain_issue(block)
                    if issued:
                        steps += block
                if self._plain_pending and (
                    not issued or len(self._plain_pending) >= self._plain_depth
                ):
                    self._plain_drain()
                elif not issued:
                    break
            while self._plain_pending:
                self._plain_drain()
            return self.finished
        while (self.pending or self.active or self._admitting) and (
            max_steps is None or steps < max_steps
        ):
            self.step()
            steps += 1
        return self.finished

    # -- metrics -----------------------------------------------------------
    def stats(self) -> dict:
        ttfts = sorted(r.ttft for r in self.finished if r.ttft is not None)
        total_toks = sum(len(r.tokens) for r in self.finished)
        out = {
            "requests": len(self.finished),
            "decode_steps": self._steps,
            "tokens_discarded": self._tokens_discarded,
            "total_tokens": total_toks,
            "p50_ttft_s": ttfts[len(ttfts) // 2] if ttfts else None,
            "p99_ttft_s": ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))] if ttfts else None,
        }
        if self.spec is not None:
            out["spec_forwards"] = self._spec_forwards
        return out
