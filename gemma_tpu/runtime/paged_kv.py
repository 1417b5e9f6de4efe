"""Paged KV-cache: block-table indirection over a shared page pool.

Generalizes the reference's dead `kv_cell`/seq-id machinery
(`/root/reference/src/gemma_model.h:75-97`, never used — SURVEY.md quirks)
into the real thing: KV memory is a pool of fixed-size pages shared by all
sequences; each sequence maps logical positions to physical pages through a
block table, so cache capacity is pooled (no per-slot worst-case
reservation) and admission is O(pages-needed).

Device state (jit-carried pytree):
    k_pages, v_pages: tuples of L per-layer pools [n_pages, H_kv,
                      page_size, D]  (one (ps, D) page of one head is one
                      contiguous block of the decode kernel; per-layer
                      buffers for the same XLA-aliasing reason as the dense
                      cache, see runtime/kv_cache.py)
    page_table:       i32 [B, max_pages_per_seq]  (physical page ids)
    length:           i32 [B]

The host-side `PageAllocator` owns the free list (the scheduler calls it at
admit/finish). `gather_layer` materializes a dense [B, H, S, D] view for the
plain attention path; the decode kernel (ops/attention.py) reads pages
directly via the block table instead.

Int8 mode mirrors runtime.kv_cache: per-(position, head) scales.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..models.config import GemmaConfig


class PageAllocator:
    """Host-side free-list over the physical page pool.

    Page 0 is reserved as the TRASH page: freed slots' block tables are
    zeroed, so decode steps of inactive batch rows (which still execute in
    the fixed-shape graph) write harmlessly into page 0 instead of pages
    that may have been re-allocated to live sequences."""

    TRASH_PAGE = 0

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PagedKVCache:
    k_pages: Any  # tuple[L] of [P, H, ps, D]
    v_pages: Any
    page_table: jax.Array  # i32 [B, maxp]
    length: jax.Array  # i32 [B]
    k_scale: Any = None  # tuple[L] of [P, H, ps] int8 mode
    v_scale: Any = None

    def tree_flatten(self):
        return (
            self.k_pages, self.v_pages, self.page_table, self.length,
            self.k_scale, self.v_scale,
        ), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        config: GemmaConfig,
        batch: int,
        n_pages: int,
        page_size: int = 64,
        max_seq_len: int | None = None,
        dtype=jnp.bfloat16,
        quantized: bool = False,
        identity_layout: bool = False,
    ) -> "PagedKVCache":
        """`identity_layout=True` pre-assigns each slot a private contiguous
        page range (slot b -> pages 1 + b*maxp .. 1 + (b+1)*maxp - 1), so the
        cache is usable directly by `Engine.prefill`/`generate` without a
        `PageAllocator`. The default all-zeros table points every write at
        the trash page — correct ONLY for scheduler-managed caches where
        `insert_sequence` installs real tables at admission."""
        msl = max_seq_len or config.context_length
        if msl % page_size != 0:
            # a floored table would silently clamp decode writes past
            # maxp*ps into the sequence's last page, corrupting KV
            raise ValueError(
                f"max_seq_len ({msl}) must be a multiple of page_size ({page_size})"
            )
        maxp = msl // page_size
        L = config.n_layers
        shape = (n_pages, config.n_kv_heads, page_size, config.head_dim)
        if identity_layout:
            if n_pages < batch * maxp + 1:
                raise ValueError(
                    f"identity_layout needs n_pages >= batch*max_pages+1 = "
                    f"{batch * maxp + 1}, got {n_pages}"
                )
            page_table = 1 + jnp.arange(batch * maxp, dtype=jnp.int32).reshape(batch, maxp)
        else:
            page_table = jnp.zeros((batch, maxp), jnp.int32)
        kw = {}
        if quantized:
            kw = dict(
                k_scale=tuple(jnp.zeros(shape[:-1], jnp.float32) for _ in range(L)),
                v_scale=tuple(jnp.zeros(shape[:-1], jnp.float32) for _ in range(L)),
            )
        pdt = jnp.int8 if quantized else dtype
        return cls(
            k_pages=tuple(jnp.zeros(shape, pdt) for _ in range(L)),
            v_pages=tuple(jnp.zeros(shape, pdt) for _ in range(L)),
            page_table=page_table,
            length=jnp.zeros(batch, jnp.int32),
            **kw,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def n_layers(self) -> int:
        return len(self.k_pages)

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_pages[0].shape[0]

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    # -- quantization (same scheme as KVCache) -----------------------------
    @staticmethod
    def _quantize(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
        scale = amax / 127.0
        inv = jnp.where(scale > 0, 1.0 / jnp.where(scale == 0, 1.0, scale), 0.0)
        return jnp.round(x.astype(jnp.float32) * inv[..., None]).astype(jnp.int8), scale

    # -- reads -------------------------------------------------------------
    def gather_layer(self, layer: int) -> tuple[jax.Array, jax.Array]:
        """Dense [B, H, S, D] view via block-table gather (plain path; the
        decode kernel avoids this materialization)."""
        B, maxp = self.page_table.shape
        ps = self.page_size

        def dense(pages, scale):
            g = pages[layer][self.page_table]  # [B, maxp, H, ps, D]
            H, D = g.shape[2], g.shape[4]
            g = g.transpose(0, 2, 1, 3, 4).reshape(B, H, maxp * ps, D)
            if scale is not None:
                sc = scale[layer][self.page_table]  # [B, maxp, H, ps]
                sc = sc.transpose(0, 2, 1, 3).reshape(B, H, maxp * ps)
                g = g.astype(jnp.bfloat16) * sc[..., None].astype(jnp.bfloat16)
            return g

        return dense(self.k_pages, self.k_scale), dense(self.v_pages, self.v_scale)

    # -- writes ------------------------------------------------------------
    def _replace_layer(self, layer: int, **bufs) -> "PagedKVCache":
        """Functional single-layer update of the page-pool tuples."""
        changes = {}
        for name, val in bufs.items():
            cur = list(getattr(self, name))
            cur[layer] = val
            changes[name] = tuple(cur)
        return dataclasses.replace(self, **changes)

    def write_token(self, layer: int, index: jax.Array, k_new: jax.Array, v_new: jax.Array) -> "PagedKVCache":
        """k_new [B, 1, H, D] written at logical position index[b] of each
        sequence (physical slot via the block table)."""
        ps = self.page_size
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        H = kp.shape[1]
        page = jnp.take_along_axis(self.page_table, (index // ps)[:, None], axis=1)[:, 0]
        off = index % ps
        pg = page[:, None]
        h = jnp.arange(H)[None, :]
        of = off[:, None]
        if self.quantized:
            qk, sk = self._quantize(k_new)
            qv, sv = self._quantize(v_new)
            return self._replace_layer(
                layer,
                k_pages=kp.at[pg, h, of].set(qk[:, 0]),
                v_pages=vp.at[pg, h, of].set(qv[:, 0]),
                k_scale=self.k_scale[layer].at[pg, h, of].set(sk[:, 0]),
                v_scale=self.v_scale[layer].at[pg, h, of].set(sv[:, 0]),
            )
        return self._replace_layer(
            layer,
            k_pages=kp.at[pg, h, of].set(k_new[:, 0].astype(kp.dtype)),
            v_pages=vp.at[pg, h, of].set(v_new[:, 0].astype(vp.dtype)),
        )

    def write_chunk(self, layer: int, start: jax.Array, k_new: jax.Array, v_new: jax.Array) -> "PagedKVCache":
        """Write a [B, T, H, D] chunk at uniform logical offset `start`
        (page-aligned starts recommended; used by direct paged prefill)."""
        B, T, H = k_new.shape[:3]
        ps = self.page_size
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        pos = start + jnp.arange(T, dtype=jnp.int32)  # [T]
        page = jnp.take_along_axis(
            self.page_table, (pos // ps)[None].repeat(B, 0), axis=1
        )  # [B, T]
        off = (pos % ps)[None].repeat(B, 0)
        pg = page[:, :, None]
        h = jnp.arange(H)[None, None, :]
        of = off[:, :, None]
        if self.quantized:
            qk, sk = self._quantize(k_new)
            qv, sv = self._quantize(v_new)
            return self._replace_layer(
                layer,
                k_pages=kp.at[pg, h, of].set(qk),
                v_pages=vp.at[pg, h, of].set(qv),
                k_scale=self.k_scale[layer].at[pg, h, of].set(sk),
                v_scale=self.v_scale[layer].at[pg, h, of].set(sv),
            )
        return self._replace_layer(
            layer,
            k_pages=kp.at[pg, h, of].set(k_new.astype(kp.dtype)),
            v_pages=vp.at[pg, h, of].set(v_new.astype(vp.dtype)),
        )

    def advance(self, n: jax.Array) -> "PagedKVCache":
        return dataclasses.replace(self, length=self.length + n)

    # -- sequence insertion (host-assisted; pages chosen by the allocator) --
    def insert_sequence(
        self,
        slot: jax.Array,  # scalar
        pages: jax.Array,  # i32 [n_assigned] physical ids (padded with 0s ok)
        n_pages_used: jax.Array,  # scalar count of valid entries in `pages`
        k_seq: jax.Array,  # [L, H, T, D], T multiple of page_size
        v_seq: jax.Array,
        length: jax.Array,  # scalar true token count
        k_scale: jax.Array | None = None,  # [L, H, T]
        v_scale: jax.Array | None = None,
    ) -> "PagedKVCache":
        L, H, T, D = k_seq.shape
        ps = self.page_size
        n = T // ps
        # [L, H, T, D] -> per layer [n, H, ps, D]
        k_c = k_seq.reshape(L, H, n, ps, D).transpose(0, 2, 1, 3, 4)
        v_c = v_seq.reshape(L, H, n, ps, D).transpose(0, 2, 1, 3, 4)
        # only the first n_pages_used chunks are real; scatter the rest to a
        # harmless target (page `pages[i]` repeated — overwritten later)
        changes: dict[str, Any] = dict(
            k_pages=tuple(
                self.k_pages[l].at[pages[:n]].set(k_c[l].astype(self.k_pages[l].dtype))
                for l in range(L)
            ),
            v_pages=tuple(
                self.v_pages[l].at[pages[:n]].set(v_c[l].astype(self.v_pages[l].dtype))
                for l in range(L)
            ),
            page_table=jax.lax.dynamic_update_slice(
                self.page_table, pages[None, : self.page_table.shape[1]], (slot, 0)
            ),
            length=self.length.at[slot].set(length),
        )
        if self.quantized:
            k_sc = k_scale.reshape(L, H, n, ps).transpose(0, 2, 1, 3)
            v_sc = v_scale.reshape(L, H, n, ps).transpose(0, 2, 1, 3)
            changes["k_scale"] = tuple(
                self.k_scale[l].at[pages[:n]].set(k_sc[l]) for l in range(L)
            )
            changes["v_scale"] = tuple(
                self.v_scale[l].at[pages[:n]].set(v_sc[l]) for l in range(L)
            )
        del n_pages_used
        return dataclasses.replace(self, **changes)
