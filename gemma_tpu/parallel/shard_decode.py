"""Explicit-collectives tensor parallelism: shard_map decode/prefill.

The GSPMD path (parallel/sharding.py) annotates weights and lets the
compiler insert collectives — but a `pallas_call` under GSPMD sees the
FULL logical weight, so XLA all-gathers every sharded QTensor before each
kernel: TP decode gets no benefit from the fused kernels. This module is
the latency-critical alternative SURVEY.md §2 mandates ("explicit
psum/all_gather/reduce_scatter in shard_map for the decode path"): weights
are laid out so each device's shard_map-local view IS a self-contained
Megatron shard, the kernels run on those local QTensors unchanged, and the
only cross-device traffic is one psum after attn_output, one after ffn_down
(models/gemma.py `tp_axis`) and one logits all-gather — the multi-device
generalization of the reference's async offload + join
(/root/reference/src/hpc.cpp:259-277).

Sharding plan (axis sizes tp = mesh["model"], dp = mesh["data"]):
  attn_q / ffn_gate / ffn_up   row-sharded (per-shard refused into
                               attn_qkv / ffn_gate_up when formats match)
  attn_k / attn_v              row-sharded when n_kv_heads % tp == 0,
                               else replicated (MQA: every shard computes
                               the single KV head)
  attn_output / ffn_down       col-sharded (K dim) -> psum
  embed (tied head)            vocab-row-sharded -> masked gather + psum
                               in; logits all-gather out
  norms                        replicated
  KV cache                     batch over "data"; heads over "model" when
                               divisible, else replicated. Dense bf16 or
                               int8-quantized (per-(pos, head) scales are
                               head-local, so each shard quantizes its own
                               heads); the paged pool shards over heads
                               too but requires dp=1 (one global pool)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..models.config import GemmaConfig
from ..quant.qtensor import QTensor, concat_rows
from .sharding import DATA_AXIS, MODEL_AXIS

Params = dict[str, Any]


def _shard_map():
    try:
        return jax.shard_map  # jax >= 0.5
    except AttributeError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

        return shard_map


def _check_tp(cfg: GemmaConfig, tp: int) -> bool:
    """True when KV heads shard evenly; False when each shard instead owns
    ONE (possibly duplicated) KV head — the Megatron GQA rule, requiring
    tp % n_kv_heads == 0 so a shard's query heads map to a single KV head."""
    if cfg.n_kv_heads % tp == 0:
        return True
    if tp % cfg.n_kv_heads != 0 or cfg.n_heads % tp != 0:
        raise ValueError(
            f"tp={tp} incompatible with heads {cfg.n_heads}/{cfg.n_kv_heads}"
        )
    return False


def local_config(cfg: GemmaConfig, tp: int) -> GemmaConfig:
    """Per-shard geometry for the shard_map forward."""
    kv_shard = _check_tp(cfg, tp)
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp if kv_shard else 1,
        d_ff=cfg.d_ff // tp,
        vocab_size=cfg.vocab_size // tp,
    )


def cache_heads(cfg: GemmaConfig, tp: int) -> int:
    """KV-head slots in the GLOBAL sharded cache: one local-head block per
    shard (duplicated heads get duplicated slots in select mode)."""
    return cfg.n_kv_heads if _check_tp(cfg, tp) else tp


def _slice_rows(w, lo: int, hi: int):
    """Logical out-feature rows [lo:hi) of a weight (QTensor N = arrays
    dim 1; dense = dim 0)."""
    if isinstance(w, QTensor):
        return QTensor(w.fmt, {k: a[:, lo:hi] for k, a in w.arrays.items()})
    return w[lo:hi]


def _concat_rows(parts):
    if isinstance(parts[0], QTensor):
        return concat_rows(parts)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def _shard_rows_refused(ws: list, tp: int):
    """Row-shard several projections and re-fuse PER SHARD, returning the
    permuted global weight whose contiguous 1/tp slices are the per-shard
    fused locals. `ws` entries are (weight, mode) pairs; mode "even" splits
    rows 1/tp, ("head", n_heads, head_dim) gives shard i the single head
    its query heads map to (duplicated when tp > n_heads)."""
    shards = []
    for i in range(tp):
        parts = []
        for w, mode in ws:
            n = w.shape[0]
            if mode == "even":
                parts.append(_slice_rows(w, i * n // tp, (i + 1) * n // tp))
            else:
                _, n_heads, head_dim = mode
                h = i * n_heads // tp  # kv head owned by this shard
                parts.append(_slice_rows(w, h * head_dim, (h + 1) * head_dim))
        shards.append(_concat_rows(parts) if len(parts) > 1 else parts[0])
    return _concat_rows(shards)


def _put(w, mesh: Mesh, spec: P):
    if isinstance(w, QTensor):
        # arrays are [K-granule, N]: logical rows = dim 1, cols = dim 0
        sub = P(spec[1] if len(spec) > 1 else None, spec[0])
        return QTensor(
            w.fmt,
            {k: jax.device_put(a, NamedSharding(mesh, sub)) for k, a in w.arrays.items()},
        )
    return jax.device_put(np.asarray(w), NamedSharding(mesh, spec))


def build_tp_params(params: Params, cfg: GemmaConfig, mesh: Mesh) -> Params:
    """Place a (host or device) parameter pytree for the shard_map step."""
    tp = mesh.shape[MODEL_AXIS]
    kv_shard = _check_tp(cfg, tp)
    row = P(MODEL_AXIS, None)
    col = P(None, MODEL_AXIS)

    def rep_put(w):
        return jax.device_put(np.asarray(w), NamedSharding(mesh, P()))

    out: Params = {
        "embed": _put(params["embed"], mesh, row),
        "final_norm": rep_put(params["final_norm"]),
        "layers": [],
    }
    if "output" in params:
        out["output"] = _put(params["output"], mesh, row)
    for lp in params["layers"]:
        nl: Params = {}
        for k, v in lp.items():
            if k.endswith("_norm") or k in (
                "post_attention_norm", "post_ffw_norm", "attn_q_norm", "attn_k_norm"
            ):
                nl[k] = rep_put(v)
        if "attn_qkv" in lp:
            q, k_, v_ = _split_qkv(lp["attn_qkv"], cfg)
        else:
            q, k_, v_ = lp["attn_q"], lp["attn_k"], lp["attn_v"]
        kv_mode = "even" if kv_shard else ("head", cfg.n_kv_heads, cfg.head_dim)
        fused = _shard_rows_refused([(q, "even"), (k_, kv_mode), (v_, kv_mode)], tp)
        nl["attn_qkv"] = _put(fused, mesh, row)
        if "ffn_gate_up" in lp:
            g, u = _split_rows(lp["ffn_gate_up"], cfg.d_ff)
        else:
            g, u = lp["ffn_gate"], lp["ffn_up"]
        nl["ffn_gate_up"] = _put(
            _shard_rows_refused([(g, "even"), (u, "even")], tp), mesh, row
        )
        nl["attn_output"] = _put(lp["attn_output"], mesh, col)
        nl["ffn_down"] = _put(lp["ffn_down"], mesh, col)
        out["layers"].append(nl)
    return out


def _split_rows(w, at: int):
    n = w.shape[0]
    return _slice_rows(w, 0, at), _slice_rows(w, at, n)


def _split_qkv(w, cfg: GemmaConfig):
    q = _slice_rows(w, 0, cfg.q_dim)
    k = _slice_rows(w, cfg.q_dim, cfg.q_dim + cfg.kv_dim)
    v = _slice_rows(w, cfg.q_dim + cfg.kv_dim, cfg.q_dim + 2 * cfg.kv_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Spec trees for shard_map
# ---------------------------------------------------------------------------

def _param_specs(params: Params, cfg: GemmaConfig, mesh: Mesh):
    tp = mesh.shape[MODEL_AXIS]
    kv_shard = cfg.n_kv_heads % tp == 0
    del kv_shard  # the refused qkv is row-sharded regardless

    def qspec(w, spec: P):
        if isinstance(w, QTensor):
            sub = P(spec[1] if len(spec) > 1 else None, spec[0])
            return QTensor(w.fmt, {k: sub for k in w.arrays})
        return spec

    specs: Params = {
        "embed": qspec(params["embed"], P(MODEL_AXIS, None)),
        "final_norm": P(),
        "layers": [],
    }
    if "output" in params:
        specs["output"] = qspec(params["output"], P(MODEL_AXIS, None))
    for lp in params["layers"]:
        sl = {}
        for k, v in lp.items():
            if k == "attn_qkv" or k == "ffn_gate_up":
                sl[k] = qspec(v, P(MODEL_AXIS, None))
            elif k in ("attn_output", "ffn_down"):
                sl[k] = qspec(v, P(None, MODEL_AXIS))
            else:
                sl[k] = P()
        specs["layers"].append(sl)
    return specs


def cache_specs(cfg: GemmaConfig, mesh: Mesh, batch: int, cache) -> Any:
    """KV-cache pytree specs: batch over data, head-slots over model (the
    cache is created with cache_heads() slots: one local block per shard).
    Works for both the dense KVCache and the PagedKVCache pool; int8 scale
    arrays shard with their pages/rows (each shard quantizes its own heads
    at write time, so scales are naturally shard-local)."""
    tp = mesh.shape[MODEL_AXIS]
    dp = mesh.shape[DATA_AXIS]
    h = MODEL_AXIS if tp > 1 else None
    b = DATA_AXIS if batch % dp == 0 and dp > 1 else None
    if hasattr(cache, "page_table"):
        # the page pool is one global resource indexed by every sequence's
        # block table — it shards over heads (model) but CANNOT shard over
        # data: a dp-replicated pool written by different data shards would
        # silently diverge. TPEngine enforces dp == 1 for paged mode.
        if dp > 1:
            raise ValueError("paged TP caches require a data axis of 1")
        kv = P(None, h, None, None)  # per-layer [P, H, ps, D]
        sc = P(None, h, None)  # per-layer [P, H, ps]
        L = cache.n_layers
        return dataclasses.replace(
            cache,
            k_pages=tuple(kv for _ in range(L)),
            v_pages=tuple(kv for _ in range(L)),
            page_table=P(None), length=P(None),
            k_scale=None if cache.k_scale is None else tuple(sc for _ in range(L)),
            v_scale=None if cache.v_scale is None else tuple(sc for _ in range(L)),
        )
    kv = P(b, h, None, None)  # per-layer [B, H, S, D]
    sc = P(b, h, None)  # per-layer [B, H, S]
    L = cache.n_layers
    return dataclasses.replace(
        cache,
        k=tuple(kv for _ in range(L)), v=tuple(kv for _ in range(L)),
        length=P(b),
        k_scale=None if cache.k_scale is None else tuple(sc for _ in range(L)),
        v_scale=None if cache.v_scale is None else tuple(sc for _ in range(L)),
    )


class TPEngine:
    """Tensor-parallel engine: prefill + decode steps inside shard_map with
    explicit collectives. API mirrors runtime.Engine's core surface
    (`_step`/`_block`/`prefill_standalone`/`insert_sequence`/`ecfg`), so
    `runtime.Scheduler` drives it unchanged — multi-chip continuous batching
    (config 5) is the same code path as single-chip."""

    def __init__(self, cfg: GemmaConfig, params: Params, mesh: Mesh,
                 max_seq_len: int = 512, max_batch: int = 1,
                 donate_cache: bool = True, kv_quantized: bool = False,
                 paged: bool = False, page_size: int = 64,
                 n_pages: int | None = None):
        shard_map = _shard_map()

        self.cfg = cfg
        self.mesh = mesh
        self.tp = mesh.shape[MODEL_AXIS]
        self.lcfg = local_config(cfg, self.tp)
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        from ..runtime.engine import EngineConfig

        if paged and mesh.shape[DATA_AXIS] > 1:
            raise ValueError(
                "paged TP serving requires a data axis of 1 (the page pool "
                "is a single global resource; see cache_specs)"
            )
        self.ecfg = EngineConfig(max_seq_len=max_seq_len, max_batch=max_batch,
                                 donate_cache=donate_cache, paged=paged,
                                 page_size=page_size, n_pages=n_pages,
                                 kv_quantized=kv_quantized)
        self.params = build_tp_params(params, cfg, mesh)
        pspecs = _param_specs(self.params, cfg, mesh)

        from ..models import gemma

        lcfg = self.lcfg
        batch_spec = P(DATA_AXIS) if max_batch % mesh.shape[DATA_AXIS] == 0 and mesh.shape[DATA_AXIS] > 1 else P(None)
        bleading = batch_spec

        def cspecs(cache):
            return cache_specs(cfg, mesh, max_batch, cache)

        cache0 = self.new_cache(max_batch)
        cspec_tree = cspecs(cache0)
        self._cache_spec_tree = cspec_tree
        del cache0

        def prefill_local(params, tokens, lengths, cache):
            B, T = tokens.shape
            positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
            logits, cache = gemma.forward(
                params, lcfg, tokens, positions, cache,
                write_index=jnp.asarray(0, jnp.int32), kv_limit=lengths,
                tp_axis=MODEL_AXIS, logits_at=lengths - 1,
            )
            cache = dataclasses.replace(cache, length=lengths)
            # assemble full logits (vocab shards are contiguous slices),
            # dropping any vocab-padding rows (params.py pad_vocab)
            full = jax.lax.all_gather(logits[:, 0], MODEL_AXIS, axis=1, tiled=True)
            return full[:, : cfg.vocab_size], cache

        def decode_local(params, tokens, cache):
            B = tokens.shape[0]
            positions = cache.length[:, None]
            logits, cache = gemma.forward(
                params, lcfg, tokens[:, None], positions, cache,
                write_index=cache.length, kv_limit=cache.length + 1,
                tp_axis=MODEL_AXIS,
            )
            cache = cache.advance(1)
            full = jax.lax.all_gather(logits[:, 0], MODEL_AXIS, axis=1, tiled=True)
            return full[:, : cfg.vocab_size], cache

        self._prefill = jax.jit(
            shard_map(
                prefill_local, mesh=mesh,
                in_specs=(pspecs, bleading, bleading, cspec_tree),
                out_specs=(bleading, cspec_tree),
                check_vma=False,
            ),
            donate_argnums=(3,) if donate_cache else (),
        )
        # batch-REPLICATED prefill for standalone (batch-1) admission
        # prefills: TP still splits the compute; the batch axis stays whole
        # so any B works regardless of the data-axis size. Always a DENSE
        # cache (paged engines too — the insert tuple is dense; the paged
        # insert reshapes it into whole pages, as in Engine)
        cache1 = self._dense_cache(1)
        cspec1 = cache_specs(cfg, mesh, 1, cache1)
        self._cache_spec1 = cspec1
        del cache1
        self._prefill_rep = jax.jit(
            shard_map(
                prefill_local, mesh=mesh,
                in_specs=(pspecs, P(None), P(None), cspec1),
                out_specs=(P(None), cspec1),
                check_vma=False,
            ),
        )
        self._decode = jax.jit(
            shard_map(
                decode_local, mesh=mesh,
                in_specs=(pspecs, bleading, cspec_tree),
                out_specs=(bleading, cspec_tree),
                check_vma=False,
            ),
            donate_argnums=(2,) if donate_cache else (),
        )

        # fused sample+decode (Engine._step_impl analogue): sampling runs on
        # the gathered logits OUTSIDE shard_map but INSIDE one jit program —
        # still one dispatch per token
        decode_sharded = shard_map(
            decode_local, mesh=mesh,
            in_specs=(pspecs, bleading, cspec_tree),
            out_specs=(bleading, cspec_tree),
            check_vma=False,
        )

        # speculative verify forward (runtime.speculative.SpecDecoder calls
        # engine.spec_verify from inside its own jit): the [B, T=k+1]
        # multi-position forward runs shard_mapped like decode, logits for
        # ALL T rows are all-gathered, and the draft/acceptance/history
        # logic stays replicated in the decoder — TP speculative serving is
        # the same Scheduler code path as single-chip (dense cache only,
        # which the Scheduler already enforces for speculation)
        def verify_local(params, toks, cache):
            T = toks.shape[1]
            lengths = cache.length
            positions = lengths[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
            logits, cache = gemma.forward(
                params, lcfg, toks, positions, cache,
                write_index=lengths, kv_limit=lengths + T, tp_axis=MODEL_AXIS,
            )
            full = jax.lax.all_gather(logits, MODEL_AXIS, axis=2, tiled=True)
            return full[:, :, : cfg.vocab_size], cache

        self.spec_verify = shard_map(
            verify_local, mesh=mesh,
            in_specs=(pspecs, bleading, cspec_tree),
            out_specs=(bleading, cspec_tree),
            check_vma=False,
        )

        def step_impl(params, logits, key, cache, *, sampling):
            from ..runtime.sampler import sample

            if sampling.is_greedy:
                tok = sample(logits, sampling, None)
            else:
                key, sub = jax.random.split(key)
                tok = sample(logits, sampling, sub)
            next_logits, cache = decode_sharded(params, tok, cache)
            return tok, next_logits, cache, key

        def block_impl(params, logits, key, cache, *, sampling, n):
            toks = []
            for _ in range(n):
                tok, logits, cache, key = step_impl(
                    params, logits, key, cache, sampling=sampling
                )
                toks.append(tok)
            return jnp.stack(toks, axis=1), logits, cache, key

        self._step = jax.jit(
            step_impl, static_argnames=("sampling",),
            donate_argnums=(3,) if donate_cache else (),
        )
        self._block = jax.jit(
            block_impl, static_argnames=("sampling", "n"),
            donate_argnums=(3,) if donate_cache else (),
        )

    def _cache_cfg(self) -> GemmaConfig:
        return dataclasses.replace(
            self.cfg, n_kv_heads=cache_heads(self.cfg, self.tp)
        )

    def _dense_cache(self, batch: int, seq_len: int | None = None):
        from ..runtime.kv_cache import KVCache

        return KVCache.create(
            self._cache_cfg(), batch, seq_len or self.max_seq_len,
            quantized=self.ecfg.kv_quantized,
        )

    def new_cache(self, batch: int | None = None, *, identity_pages: bool = True):
        batch = batch or self.max_batch
        if self.ecfg.paged:
            from ..runtime.paged_kv import PagedKVCache

            n_pages = self.ecfg.n_pages or (
                batch * self.ecfg.max_seq_len // self.ecfg.page_size + 1
            )
            return PagedKVCache.create(
                self._cache_cfg(), batch, n_pages,
                page_size=self.ecfg.page_size,
                max_seq_len=self.ecfg.max_seq_len,
                quantized=self.ecfg.kv_quantized,
                identity_layout=identity_pages,
            )
        return self._dense_cache(batch)

    def place_cache(self, cache):
        """Device-place a cache per the shard_map specs."""
        spec_tree = self._cache_spec_tree
        return jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(self.mesh, s)),
            cache, spec_tree,
        )

    def prefill(self, prompts: list[list[int]], cache=None):
        B = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int32)
        T = 16
        while T < lengths.max():
            T *= 2
        toks = np.zeros((B, T), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        cache = cache if cache is not None else self.place_cache(self.new_cache(B))
        return self._prefill(self.params, jnp.asarray(toks), jnp.asarray(lengths), cache)

    def decode_step(self, tokens, cache):
        return self._decode(self.params, tokens, cache)

    # -- Scheduler surface (continuous batching over the TP mesh) ----------
    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        """Prefill one sequence through the batch-replicated TP graph into a
        throwaway bucket-sized cache; returns the Engine-compatible
        (logits, k_seq, v_seq, scales, length) insertion tuple. `pad_to`
        rounds T up to the decode-side page size (Engine API parity)."""
        T = 16
        while T < len(prompt):
            T *= 2
        if self.ecfg.paged:
            ps = self.ecfg.page_size
            T = -(-T // ps) * ps
        if pad_to:
            T = -(-T // pad_to) * pad_to
        tmp = self._dense_cache(1, T)
        tmp = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(self.mesh, s)),
            tmp, self._cache_spec1,
        )
        toks = np.zeros((1, T), np.int32)
        toks[0, : len(prompt)] = prompt
        logits, tmp = self._prefill_rep(
            self.params, jnp.asarray(toks), jnp.asarray([len(prompt)], np.int32), tmp
        )
        k_seq, v_seq, scales = tmp.extract_seq(0)
        return logits[0], k_seq, v_seq, scales, len(prompt)

    @functools.cached_property
    def _insert(self):
        def fn(cache, slot, k_seq, v_seq, length, k_sc, v_sc):
            return cache.insert_sequence(slot, k_seq, v_seq, length, k_sc, v_sc)

        return jax.jit(fn, donate_argnums=(0,))

    @functools.cached_property
    def _insert_paged(self):
        def fn(cache, slot, pages, n_used, k_seq, v_seq, length, k_sc, v_sc):
            return cache.insert_sequence(
                slot, pages, n_used, k_seq, v_seq, length, k_sc, v_sc
            )

        return jax.jit(fn, donate_argnums=(0,))

    def insert_sequence(self, cache, slot: int, prefill_out, pages=None):
        """Insert a prefill_standalone result into batch row `slot` of the
        sharded serving cache (GSPMD propagates the cache sharding through
        the dynamic_update_slice / page scatter)."""
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
        T = k_seq.shape[2]
        if T < S:
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

    def generate_greedy(self, prompts: list[list[int]], max_new_tokens: int):
        logits, cache = self.prefill(prompts)
        out = []
        for _ in range(max_new_tokens):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out.append(tok)
            logits, cache = self.decode_step(tok, cache)
        return np.stack([np.asarray(t) for t in out], axis=1)
