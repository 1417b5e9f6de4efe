"""KV-cache: fixed-capacity, jit-carried, optionally int8-quantized.

Counterpart of the reference's per-layer ggml cache tensors +
head/n bookkeeping (`/root/reference/src/gemma_model.h:75-97`,
`gemma_model.cpp:361-401,428-436`). Differences by design:

* **per-layer buffers** (a tuple of L arrays per K/V), like the reference's
  per-layer tensors: every decode step both writes `k[layer]` and feeds it
  to the attention kernel's custom call, and XLA cannot alias a *slice* of
  one donated stacked [L, ...] buffer into a custom call — it would copy
  slabs the size of the allocation each step. With per-layer leaves,
  donation aliases each buffer in place and decode cost does not grow
  with the allocation;
* layout is **[B, H_kv, S, D]** per layer: the decode kernel reads (bs, D)
  blocks of one (sequence, head) contiguously, with no transpose of the
  cache;
* per-sequence valid lengths (`length[b]`) instead of a single global
  `head`/`n` — multiple independent sequences batch together (the
  reference's `cells`/seq-id machinery is dead code; here it's real);
* writes are `dynamic_update_slice` / scatter under jit, not graph-rebuilt
  views (`gemma_model.cpp:499-518`);
* optional int8 per-(token, head) quantization halving cache traffic.

Cross-boundary interfaces (insert_sequence input, extract_seq output, the
kv_transfer wire format) remain STACKED [L, H, T, D] numpy/jax arrays —
one contiguous hand-off object; the per-layer split is internal to the
jit-carried state.

The paged variant lives in runtime/paged_kv.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..models.config import GemmaConfig


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KVCache:
    """Dense cache: k/v = tuples of L arrays [B, H_kv, S, D]; length[b] =
    #valid slots of sequence b."""

    k: Any  # tuple[L] of [B, H_kv, S, D]
    v: Any
    length: jax.Array  # i32 [B]
    # int8 mode: per-(batch, head, position) scales, tuple[L] of [B, H_kv, S]
    k_scale: Any = None
    v_scale: Any = None

    def tree_flatten(self):
        return (self.k, self.v, self.length, self.k_scale, self.v_scale), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        config: GemmaConfig,
        batch: int,
        max_len: int,
        dtype=jnp.bfloat16,
        quantized: bool = False,
    ) -> "KVCache":
        L = config.n_layers
        shape = (batch, config.n_kv_heads, max_len, config.head_dim)
        if quantized:
            return cls(
                k=tuple(jnp.zeros(shape, jnp.int8) for _ in range(L)),
                v=tuple(jnp.zeros(shape, jnp.int8) for _ in range(L)),
                length=jnp.zeros(batch, jnp.int32),
                k_scale=tuple(jnp.zeros(shape[:-1], jnp.float32) for _ in range(L)),
                v_scale=tuple(jnp.zeros(shape[:-1], jnp.float32) for _ in range(L)),
            )
        return cls(
            k=tuple(jnp.zeros(shape, dtype) for _ in range(L)),
            v=tuple(jnp.zeros(shape, dtype) for _ in range(L)),
            length=jnp.zeros(batch, jnp.int32),
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def n_layers(self) -> int:
        return len(self.k)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    # -- quantization helpers ---------------------------------------------
    @staticmethod
    def _quantize(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Per-(token, head) symmetric int8: x [B, T, H, D]."""
        amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
        scale = amax / 127.0
        inv = jnp.where(scale > 0, 1.0 / jnp.where(scale == 0, 1.0, scale), 0.0)
        q = jnp.round(x.astype(jnp.float32) * inv[..., None]).astype(jnp.int8)
        return q, scale

    def gather_layer(self, layer: int) -> tuple[jax.Array, jax.Array]:
        """Dequantized [B, H, S, D] views of layer `layer`."""
        k, v = self.k[layer], self.v[layer]
        if self.quantized:
            k = k.astype(jnp.bfloat16) * self.k_scale[layer][..., None].astype(jnp.bfloat16)
            v = v.astype(jnp.bfloat16) * self.v_scale[layer][..., None].astype(jnp.bfloat16)
        return k, v

    # -- layer-tuple plumbing ---------------------------------------------
    def _replace_layer(self, layer: int, **bufs) -> "KVCache":
        """Functional single-layer update of the k/v(/scale) tuples."""
        changes = {}
        for name, val in bufs.items():
            cur = list(getattr(self, name))
            cur[layer] = val
            changes[name] = tuple(cur)
        return dataclasses.replace(self, **changes)

    # -- writes ------------------------------------------------------------
    def write_chunk(self, layer: int, start: jax.Array, k_new: jax.Array, v_new: jax.Array) -> "KVCache":
        """Write a [B, T, H, D] chunk at uniform offset `start` (prefill)."""
        def upd(buf, val):  # val [B, T, H, D] -> [B, H, T, D]
            return jax.lax.dynamic_update_slice(
                buf, val.transpose(0, 2, 1, 3), (0, 0, start, 0)
            )

        if self.quantized:
            qk, sk = self._quantize(k_new)
            qv, sv = self._quantize(v_new)

            def upd_s(buf, s):  # s [B, T, H] -> [B, H, T]
                return jax.lax.dynamic_update_slice(
                    buf, s.transpose(0, 2, 1), (0, 0, start)
                )

            return self._replace_layer(
                layer,
                k=upd(self.k[layer], qk),
                v=upd(self.v[layer], qv),
                k_scale=upd_s(self.k_scale[layer], sk),
                v_scale=upd_s(self.v_scale[layer], sv),
            )
        return self._replace_layer(
            layer,
            k=upd(self.k[layer], k_new.astype(self.k[layer].dtype)),
            v=upd(self.v[layer], v_new.astype(self.v[layer].dtype)),
        )

    def write_chunk_per_seq(
        self, layer: int, starts: jax.Array, k_new: jax.Array, v_new: jax.Array
    ) -> "KVCache":
        """Write a [B, T, H, D] chunk at a DIFFERENT offset per sequence
        (batched speculative verification: every slot's k+1 draft rows land
        at its own length). Unrolled per-seq dynamic_update_slice — B tiny
        in-place updates instead of a B*T-row scatter. Starts are clamped
        in-bounds (callers guarantee ACTIVE slots never need the clamp;
        inactive serving slots may drift past capacity and their rows are
        rewritten on re-admission)."""
        B, T = k_new.shape[0], k_new.shape[1]
        S = self.max_len
        starts = jnp.clip(starts, 0, S - T)
        if self.quantized:
            qk, sk = self._quantize(k_new)
            qv, sv = self._quantize(v_new)
        else:
            qk = k_new.astype(self.k[layer].dtype)
            qv = v_new.astype(self.v[layer].dtype)
            sk = sv = None
        k, v = self.k[layer], self.v[layer]
        ks = self.k_scale[layer] if self.quantized else None
        vs = self.v_scale[layer] if self.quantized else None
        for b in range(B):  # static unroll; each DUS is [1,H,T,D]
            loc = (b, 0, starts[b], 0)
            k = jax.lax.dynamic_update_slice(k, qk[b].transpose(1, 0, 2)[None], loc)
            v = jax.lax.dynamic_update_slice(v, qv[b].transpose(1, 0, 2)[None], loc)
            if self.quantized:
                ks = jax.lax.dynamic_update_slice(ks, sk[b].T[None], (b, 0, starts[b]))
                vs = jax.lax.dynamic_update_slice(vs, sv[b].T[None], (b, 0, starts[b]))
        if self.quantized:
            return self._replace_layer(layer, k=k, v=v, k_scale=ks, v_scale=vs)
        return self._replace_layer(layer, k=k, v=v)

    def write_token(self, layer: int, index: jax.Array, k_new: jax.Array, v_new: jax.Array) -> "KVCache":
        """Scatter a single token per sequence: k_new [B, 1, H, D] written at
        per-batch position index[b] (decode). B=1 (the offline/headline
        path) lowers to a dynamic_update_slice instead of a gather-scatter —
        same result, cheaper lowering."""
        kb, vb = self.k[layer], self.v[layer]
        B, H = kb.shape[0], kb.shape[1]
        if self.quantized:
            qk, sk = self._quantize(k_new)
            qv, sv = self._quantize(v_new)
        else:
            qk, qv = k_new.astype(kb.dtype), v_new.astype(vb.dtype)
            sk = sv = None
        if B == 1:
            loc = (0, 0, index[0], 0)

            def upd(buf, val):  # val [1, 1, H, D] -> [1, H, 1, D]
                return jax.lax.dynamic_update_slice(
                    buf, val.transpose(0, 2, 1, 3), loc
                )

            if self.quantized:
                return self._replace_layer(
                    layer,
                    k=upd(kb, qk), v=upd(vb, qv),
                    k_scale=jax.lax.dynamic_update_slice(
                        self.k_scale[layer], sk.transpose(0, 2, 1), loc[:3]
                    ),
                    v_scale=jax.lax.dynamic_update_slice(
                        self.v_scale[layer], sv.transpose(0, 2, 1), loc[:3]
                    ),
                )
            return self._replace_layer(layer, k=upd(kb, qk), v=upd(vb, qv))
        b = jnp.arange(B)[:, None]
        h = jnp.arange(H)[None, :]
        idx = index[:, None]
        if self.quantized:
            return self._replace_layer(
                layer,
                k=kb.at[b, h, idx].set(qk[:, 0]),
                v=vb.at[b, h, idx].set(qv[:, 0]),
                k_scale=self.k_scale[layer].at[b, h, idx].set(sk[:, 0]),
                v_scale=self.v_scale[layer].at[b, h, idx].set(sv[:, 0]),
            )
        return self._replace_layer(
            layer,
            k=kb.at[b, h, idx].set(qk[:, 0]),
            v=vb.at[b, h, idx].set(qv[:, 0]),
        )

    def advance(self, n: jax.Array) -> "KVCache":
        return dataclasses.replace(self, length=self.length + n)

    # -- sequence hand-off (stacked [L, H, T, D] boundary format) ----------
    def extract_seq(self, b: int = 0):
        """Pull batch row `b` out as the stacked insert tuple parts:
        (k_seq [L, H, S, D], v_seq, (k_scale [L, H, S] | None, v_scale)).
        One materializing stack — used at the prefill->serving hand-off,
        once per admitted sequence (never in the decode step)."""
        k_seq = jnp.stack([kl[b] for kl in self.k])
        v_seq = jnp.stack([vl[b] for vl in self.v])
        if self.quantized:
            scales = (
                jnp.stack([sl[b] for sl in self.k_scale]),
                jnp.stack([sl[b] for sl in self.v_scale]),
            )
        else:
            scales = (None, None)
        return k_seq, v_seq, scales

    def insert_sequence(
        self,
        slot: jax.Array,  # scalar i32
        k_seq: jax.Array,  # [L, H, T, D] (already quantized if cache is)
        v_seq: jax.Array,
        length: jax.Array,  # scalar i32 true length (<= T)
        k_scale: jax.Array | None = None,  # [L, H, T] when quantized
        v_scale: jax.Array | None = None,
    ) -> "KVCache":
        """Insert a prefilled sequence's K/V into batch row `slot` (the
        prefill->insert->decode handoff of continuous batching). Slots are
        independent; the insert is one dynamic_update_slice on the batch dim
        of each layer buffer."""
        L = self.n_layers

        def upd(buf, val):  # val [H, T, D] -> [1, H, T, D] at row `slot`
            return jax.lax.dynamic_update_slice(
                buf, val[None].astype(buf.dtype), (slot, 0, 0, 0)
            )

        changes = dict(
            k=tuple(upd(self.k[l], k_seq[l]) for l in range(L)),
            v=tuple(upd(self.v[l], v_seq[l]) for l in range(L)),
            length=self.length.at[slot].set(length),
        )
        if self.quantized:
            changes["k_scale"] = tuple(
                jax.lax.dynamic_update_slice(
                    self.k_scale[l], k_scale[l][None], (slot, 0, 0)
                )
                for l in range(L)
            )
            changes["v_scale"] = tuple(
                jax.lax.dynamic_update_slice(
                    self.v_scale[l], v_scale[l][None], (slot, 0, 0)
                )
                for l in range(L)
            )
        return dataclasses.replace(self, **changes)
