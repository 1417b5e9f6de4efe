"""Parameter loading: GGUF checkpoint → JAX parameter pytree.

Replaces the reference's `load_tensors_from_ctx` + `composite_model` wiring
(`/root/reference/src/gemma_model.cpp:159-194,583-594`): the same
`token_embd.weight` / `output_norm.weight` / `blk.{i}.*.weight` names are
mapped into a nested dict pytree. Two serving policies:

* ``mode="quantized"`` (default): block-quantized matrices stay quantized as
  device-layout QTensors (HBM holds ~4.75-9 bits/weight); dequantization is
  fused into the Pallas matmul kernels.
* ``mode="dequant"``: everything dequantized to bf16 at load (the float
  golden-reference path, config 1 in BASELINE.json).

Norm vectors are always f32. The output head is tied to the embedding when
no `output.weight` tensor is present (gemma_model.cpp:163).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..quant import numpy_ref
from ..quant.qtensor import GGML_TO_FMT, QTensor, from_ggml
from .config import GemmaConfig

LAYER_TENSORS = (
    "attn_q", "attn_k", "attn_v", "attn_output",
    "ffn_gate", "ffn_up", "ffn_down",
    "attn_norm", "ffn_norm",
)

_NORM_NAMES = {"attn_norm", "ffn_norm"}

# Gemma-2/3 sandwich norms + Gemma-3 QK-norms, present only in those exports
OPTIONAL_LAYER_NORMS = (
    "post_attention_norm", "post_ffw_norm", "attn_q_norm", "attn_k_norm"
)


def _load_tensor(reader: GGUFReader, name: str, mode: str, *, is_norm: bool = False):
    ti = reader.tensors[name]
    raw = reader.tensor_raw(name)
    if is_norm or ti.ggml_type not in GGML_TO_FMT or mode == "dequant":
        from .. import native

        x = native.dequantize(raw, ti.ggml_type, ti.shape)
        if x is None:
            x = numpy_ref.dequantize(raw, ti.ggml_type, ti.shape)
        return np.asarray(x, np.float32) if is_norm else np.asarray(x, np.float32).astype(jnp.bfloat16)
    return from_ggml(raw, ti.ggml_type, ti.shape)


def _maybe_fuse(lp: dict[str, Any], names: tuple[str, ...], fused_name: str) -> None:
    """Fuse row-concatenable projections (q|k|v, gate|up) into one matmul.

    The reference issues one mul_mat per projection (gemma_model.cpp:692-696,
    444-452); fusing them cuts kernel launches and enlarges tiles.
    Only fuses when all parts share a quant format (mixed-type GGUF exports,
    e.g. Q4_K_M's Q6_K attn_v, stay separate)."""
    import numpy as np

    from ..quant.qtensor import concat_rows

    parts = [lp[n] for n in names]
    if all(isinstance(p, QTensor) for p in parts):
        if len({p.fmt for p in parts}) == 1:
            lp[fused_name] = concat_rows(parts)
            for n in names:
                del lp[n]
    elif not any(isinstance(p, QTensor) for p in parts):
        lp[fused_name] = np.concatenate([np.asarray(p) for p in parts], axis=0)
        for n in names:
            del lp[n]


def load_params(
    reader: GGUFReader,
    mode: str = "quantized",
    device_put: bool = True,
    sharding_fn=None,
    fuse_projections: bool = True,
) -> tuple[GemmaConfig, dict[str, Any]]:
    """Load (config, params). `sharding_fn(path, shape) -> Sharding | None`
    lets the parallel layer place each array shard-by-shard as it streams
    off the mmap (host never holds more than one tensor densely)."""
    cfg = GemmaConfig.from_gguf(reader)

    def pad_vocab(w):
        # quantized head/embedding: pad N to a 2048 multiple so the lm_head
        # kernel tiles at bn=2048 (see GemmaConfig.padded_vocab_size)
        if isinstance(w, QTensor):
            from ..quant.qtensor import pad_rows

            return pad_rows(w, cfg.padded_vocab_size)
        return w

    params: dict[str, Any] = {
        "embed": pad_vocab(_load_tensor(reader, "token_embd.weight", mode)),
        "final_norm": _load_tensor(reader, "output_norm.weight", mode, is_norm=True),
        "layers": [],
    }
    if "output.weight" in reader.tensors:
        params["output"] = pad_vocab(_load_tensor(reader, "output.weight", mode))
    for i in range(cfg.n_layers):
        lp = {}
        for t in LAYER_TENSORS:
            lp[t] = _load_tensor(reader, f"blk.{i}.{t}.weight", mode, is_norm=t in _NORM_NAMES)
        for t in OPTIONAL_LAYER_NORMS:
            if f"blk.{i}.{t}.weight" in reader.tensors:
                lp[t] = _load_tensor(reader, f"blk.{i}.{t}.weight", mode, is_norm=True)
        if fuse_projections:
            _maybe_fuse(lp, ("attn_q", "attn_k", "attn_v"), "attn_qkv")
            _maybe_fuse(lp, ("ffn_gate", "ffn_up"), "ffn_gate_up")
        params["layers"].append(lp)

    if device_put:
        def put(path_leaf):
            path, leaf = path_leaf
            if sharding_fn is not None:
                sh = sharding_fn(path, getattr(leaf, "shape", None))
                if sh is not None:
                    return jax.device_put(leaf, sh)
            return jax.device_put(leaf)

        params = jax.tree_util.tree_map_with_path(
            lambda p, l: put((p, l)), params
        )
    return cfg, params


def param_bytes(params) -> int:
    total = 0
    for leaf in jax.tree_util.tree_leaves(params):
        total += leaf.size * leaf.dtype.itemsize
    return total
