"""Mesh + sharding rules: tensor/data-parallel layout over the device links.

The reference's only "distribution" is a static 0.9 CPU/iGPU row split of
each matmul plus a 4-thread row fan-out (`/root/reference/src/hpc.cpp:
245-269`; SURVEY.md §2 parallelism checklist). The generalization here:
a logical ``(data, model)`` device mesh; weights annotated with
`NamedSharding` so GSPMD emits all-gather/reduce-scatter (NCCL); KV-cache
sharded over batch (data) and KV heads (model, when divisible).

Megatron-style layout per decoder layer — one psum per block, inserted by
the compiler from these specs:

* attn_q/k/v, ffn_gate/up: row-sharded  [out/model, in]
* attn_output, ffn_down:   col-sharded  [out, in/model]  → partial sums
* embeddings: vocab-sharded rows (logits computed shard-local)
* norms: replicated

QTensor leaves shard by their *array* layout: every per-group metadata array
(scales/sc/mn/d/dmin at cols/32..cols/256 granularity) has the same
(rows, col-groups) orientation as ``qs``, so one PartitionSpec applies to
the whole QTensor. All group sizes divide typical shard sizes; divisibility
is checked and falls back to replication otherwise.
"""
from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..models.config import GemmaConfig
from ..quant.qtensor import QTensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: int | None = None,
    n_model: int | None = None,
    devices=None,
) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_model is None:
        n_model = n if n_data is None else n // n_data
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return Mesh(devices.reshape(n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def _axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def _maybe(axis_name: str, dim: int, shard_count: int):
    """Shard a dim on axis_name only if it divides evenly."""
    return axis_name if dim % shard_count == 0 and shard_count > 1 else None


def param_pspec(path: str, shape: tuple[int, ...], mesh: Mesh) -> P:
    """PartitionSpec for a parameter identified by its role name."""
    tp = _axis_size(mesh, MODEL_AXIS)
    if len(shape) == 1:
        return P(None)
    rows, cols = shape[0], shape[1]
    role = path.rsplit(".", 1)[-1]
    if role in ("attn_q", "ffn_gate", "ffn_up", "attn_qkv", "ffn_gate_up"):
        return P(_maybe(MODEL_AXIS, rows, tp), None)
    if role in ("attn_k", "attn_v"):
        # KV projections shard over rows only when every device gets >= 1
        # whole head (MQA replicates)
        return P(_maybe(MODEL_AXIS, rows, tp), None)
    if role in ("attn_output", "ffn_down"):
        return P(None, _maybe(MODEL_AXIS, cols, tp))
    if role in ("embed", "output"):
        return P(_maybe(MODEL_AXIS, rows, tp), None)
    return P(None, None)


def _qtensor_sharding(qt: QTensor, spec: P, mesh: Mesh) -> QTensor:
    """Apply the logical (out-rows, in-cols) spec to each device array of a
    QTensor. Device arrays are K-major [K-granule, N]: the logical row (N)
    axis is array dim 1 and the logical col (K) axis is array dim 0. Falls
    back to replication when a granule dim doesn't divide."""
    tp = _axis_size(mesh, MODEL_AXIS)
    row_axis = spec[0]
    col_axis = spec[1] if len(spec) > 1 else None
    out = {}
    for name, arr in qt.arrays.items():
        kdim, ndim = arr.shape
        sub = P(
            col_axis if col_axis and kdim % tp == 0 else None,
            row_axis if row_axis and ndim % tp == 0 else None,
        )
        out[name] = jax.device_put(arr, NamedSharding(mesh, sub))
    return QTensor(qt.fmt, out)


def shard_params(params: dict[str, Any], mesh: Mesh) -> dict[str, Any]:
    """Place a parameter pytree on the mesh per the Megatron-style rules."""

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        if isinstance(node, QTensor):
            spec = param_pspec(path, node.shape, mesh)
            return _qtensor_sharding(node, spec, mesh)
        spec = param_pspec(path, node.shape, mesh)
        return jax.device_put(node, NamedSharding(mesh, spec))

    # strip layer indices from role detection: path ends with tensor role
    return walk(params, "")


def cache_pspec(cfg: GemmaConfig, mesh: Mesh, batch: int, quant_scale: bool = False) -> P:
    """Spec for one KVCache k/v layer buffer [B, H_kv, S, D] (scale:
    [B, H_kv, S]): batch over data, KV heads over model."""
    dp = _axis_size(mesh, DATA_AXIS)
    tp = _axis_size(mesh, MODEL_AXIS)
    b_axis = _maybe(DATA_AXIS, batch, dp)
    h_axis = _maybe(MODEL_AXIS, cfg.n_kv_heads, tp)
    if quant_scale:
        return P(b_axis, h_axis, None)
    return P(b_axis, h_axis, None, None)


def shard_cache(cache, cfg: GemmaConfig, mesh: Mesh):
    import dataclasses

    batch = cache.batch
    kv_spec = NamedSharding(mesh, cache_pspec(cfg, mesh, batch))
    sc_spec = NamedSharding(mesh, cache_pspec(cfg, mesh, batch, quant_scale=True))
    len_spec = NamedSharding(mesh, P(None))
    return dataclasses.replace(
        cache,
        k=jax.device_put(cache.k, kv_spec),
        v=jax.device_put(cache.v, kv_spec),
        length=jax.device_put(cache.length, len_spec),
        k_scale=None if cache.k_scale is None else jax.device_put(cache.k_scale, sc_spec),
        v_scale=None if cache.v_scale is None else jax.device_put(cache.v_scale, sc_spec),
    )
