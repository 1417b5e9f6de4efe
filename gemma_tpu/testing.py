"""Test/benchmark fixtures: fabricate valid Gemma GGUF checkpoints.

There is no network egress in CI, so tests and benches fabricate real GGUF
files (through the public writer) at arbitrary scale — from 2-layer toys to
full Gemma-7B geometry with random weights (throughput does not depend on
weight values).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .gguf.constants import GGMLType, Keys
from .gguf.writer import GGUFWriter
from .models.config import GemmaConfig
from .quant import numpy_ref

TINY_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
)

# Gemma-2-style toy: sandwich norms, softcaps, alternating sliding window
TINY_GEMMA2_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
    sliding_window=16, swa_pattern=2, attn_softcap=50.0, final_softcap=30.0,
)

# Gemma-3-style toy: QK-norm, 5-local/1-global cadence, split rope bases,
# linear rope scaling on the global layers
TINY_GEMMA3_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=6, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
    sliding_window=16, swa_pattern=6,
    rope_base=1_000_000.0, rope_base_swa=10_000.0, rope_scale=1.0 / 8.0,
)


def random_matrix(rng, rows: int, cols: int, fmt: str, fill: str = "random"):
    """One [rows, cols] = [out, in] weight in device layout: a QTensor of
    format `fmt` with random payloads and small positive scales, or a bf16
    array for fmt='bf16'. With fill='zeros' payloads are zeros (fast);
    scales are still nonzero so nothing degenerates."""
    import jax.numpy as jnp

    from .quant.qtensor import QTensor, store_f16

    if fmt == "bf16":
        if fill == "zeros":
            return np.zeros((rows, cols), dtype=jnp.bfloat16)
        return (rng.standard_normal((rows, cols), dtype=np.float32) * 0.05).astype(jnp.bfloat16)

    def payload(shape, dtype):
        if fill == "zeros":
            return np.zeros(shape, dtype)
        if np.issubdtype(dtype, np.unsignedinteger):
            return rng.integers(0, 256, size=shape, dtype=np.uint8).view(dtype)
        return rng.integers(-100, 100, size=shape, dtype=np.int8).view(dtype)

    def scales(shape):
        # f16-grid values on the bf16 storage grid (qtensor.SCALE_DTYPE)
        return store_f16((rng.uniform(0.5, 1.0, size=shape) * 0.01).astype(np.float32))

    def sub_scales(shape):
        # exact int8 sub-scales (K-quant layout): small nonzero ints
        if fill == "zeros":
            return np.ones(shape, np.int8)
        return rng.integers(1, 64, size=shape, dtype=np.int8)

    # device layout is K-major: arrays are [K-granule, N] (see qtensor.py)
    if fmt == "q4_0":
        arrays = {"qs": payload((cols // 2, rows), np.uint8), "scales": scales((cols // 32, rows))}
    elif fmt == "q8_0":
        arrays = {"qs": payload((cols, rows), np.int8), "scales": scales((cols // 32, rows))}
    elif fmt == "q4_k":
        # meta rows per superblock: 16 int8 sub-scales + the bf16
        # d/dmin quad's lo/hi byte rows (see qtensor.pack_q4_k)
        n_sb = cols // 256
        dmu = scales((n_sb, 4, rows)).view(np.uint16)
        meta = np.concatenate(
            [
                sub_scales((n_sb, 16, rows)).astype(np.int8),
                (dmu & 0xFF).astype(np.int8),
                (dmu >> 8).astype(np.int8),
            ],
            axis=1,
        ).reshape(3 * cols // 32, rows)
        arrays = {"qs": payload((cols // 2, rows), np.uint8), "meta": meta}
    elif fmt == "q6_k":
        arrays = {
            "ql": payload((cols // 2, rows), np.uint8),
            "qh": payload((cols // 4, rows), np.uint8),
            "sc8": sub_scales((cols // 16, rows)),
            "d": scales((cols // 64, rows)),
        }
    else:
        raise ValueError(fmt)
    return QTensor(fmt, arrays)


def make_params(
    cfg: GemmaConfig,
    fmt: str = "q4_0",
    seed: int = 0,
    fill: str = "random",
):
    """Fabricate a parameter pytree directly (no GGUF round-trip).

    Used for compile checks and throughput benchmarks at full model scale,
    where writing a multi-GB GGUF first would be wasted IO. `fmt` is a
    QTensor format name, 'bf16', or 'q4_k_m' — the mixed llama.cpp Q4_K_M
    recipe the reference actually serves (/root/reference/src/app.cpp:36):
    q4_k matrices with q6_k attn_v and the q6_k tied embedding/output head.
    Weights come from `random_matrix`.
    """
    rng = np.random.default_rng(seed)
    mixed = fmt == "q4_k_m"

    def mat(rows: int, cols: int, fmt_override: str | None = None):
        fmt_ = fmt_override or ("q4_k" if mixed else fmt)
        return random_matrix(rng, rows, cols, fmt_, fill)

    def norm(d):
        return np.ones(d, np.float32)

    def layer():
        lp = {
            "attn_output": mat(cfg.d_model, cfg.q_dim),
            "ffn_gate_up": mat(2 * cfg.d_ff, cfg.d_model),
            "ffn_down": mat(cfg.d_model, cfg.d_ff),
            "attn_norm": norm(cfg.d_model),
            "ffn_norm": norm(cfg.d_model),
        }
        if mixed:
            # Q4_K_M: attn_v is q6_k, so q/k/v stay unfused (the loader's
            # mixed-format fuse guard, params._maybe_fuse)
            lp["attn_q"] = mat(cfg.q_dim, cfg.d_model)
            lp["attn_k"] = mat(cfg.kv_dim, cfg.d_model)
            lp["attn_v"] = mat(cfg.kv_dim, cfg.d_model, "q6_k")
        else:
            lp["attn_qkv"] = mat(cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model)
        return lp

    params = {
        # embedding/head padded to the 2048-aligned vocab, as load_params does
        "embed": mat(cfg.padded_vocab_size if fmt != "bf16" else cfg.vocab_size,
                     cfg.d_model, "q6_k" if mixed else None),
        "final_norm": norm(cfg.d_model),
        "layers": [layer() for _ in range(cfg.n_layers)],
    }
    return params


def default_vocab(n: int) -> tuple[list[str], list[float], list[int]]:
    """SPM-style vocab: specials, byte-fallback tokens, then words."""
    tokens = ["<pad>", "<bos>", "<eos>", "<unk>", "<start_of_turn>", "<end_of_turn>"]
    types = [3, 3, 3, 2, 3, 3]
    scores = [0.0] * 6
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(6)
        scores.append(0.0)
    words = ["▁the", "▁hello", "▁world", "▁a", "he", "llo", "wor", "ld", "▁he",
             "▁wo", "l", "o", "r", "d", "e", "h", "w", "a", "t", "▁", "s", "in",
             "er", "an", "on", "▁to", "▁of", "nd", "▁and", "ing"]
    i = 0
    while len(tokens) < n:
        if i < len(words):
            w = words[i]
        else:
            w = f"tok{i}"
        tokens.append(w)
        types.append(1)
        scores.append(-float(len(tokens)))  # longer id -> lower score
        i += 1
    return tokens[:n], scores[:n], types[:n]


def make_gguf(
    path: str | Path,
    cfg: GemmaConfig = TINY_CONFIG,
    *,
    weight_type: GGMLType = GGMLType.F32,
    seed: int = 0,
    scale: float = 0.05,
    arch: str = "gemma",
) -> Path:
    """Write a GGUF checkpoint with random N(0, scale²) weights.

    `weight_type` applies to all 2-D matrices; norms stay F32. Matrix shapes
    follow the llama.cpp export convention ([out, in] logical numpy order).
    """
    rng = np.random.default_rng(seed)
    path = Path(path)
    w = GGUFWriter(path)
    w.add_kv(Keys.ARCHITECTURE, arch)
    w.add_kv(Keys.NAME, "gemma-tpu-synthetic")
    if cfg.sliding_window:
        w.add_kv(f"{arch}.attention.sliding_window", cfg.sliding_window)
    if cfg.attn_softcap:
        w.add_kv(f"{arch}.attn_logit_softcapping", cfg.attn_softcap)
    if cfg.final_softcap:
        w.add_kv(f"{arch}.final_logit_softcapping", cfg.final_softcap)
    w.add_kv(f"{arch}.context_length", cfg.context_length)
    w.add_kv(f"{arch}.embedding_length", cfg.d_model)
    w.add_kv(f"{arch}.block_count", cfg.n_layers)
    w.add_kv(f"{arch}.feed_forward_length", cfg.d_ff)
    w.add_kv(f"{arch}.attention.head_count", cfg.n_heads)
    w.add_kv(f"{arch}.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv(f"{arch}.attention.key_length", cfg.head_dim)
    w.add_kv(f"{arch}.attention.value_length", cfg.head_dim)
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_kv(f"{arch}.rope.freq_base", cfg.rope_base)
    if cfg.rope_base_swa:
        w.add_kv(f"{arch}.rope.freq_base_swa", cfg.rope_base_swa)
    if cfg.rope_scale != 1.0:
        w.add_kv(f"{arch}.rope.scaling.type", "linear")
        w.add_kv(f"{arch}.rope.scaling.factor", 1.0 / cfg.rope_scale)

    tokens, scores, types = default_vocab(cfg.vocab_size)
    w.add_kv(Keys.TOKENIZER_MODEL, "llama")
    w.add_kv(Keys.TOKENS, tokens)
    w.add_kv(Keys.SCORES, np.asarray(scores, np.float32))
    w.add_kv(Keys.TOKEN_TYPE, np.asarray(types, np.int32))
    w.add_kv(Keys.BOS_ID, 1)
    w.add_kv(Keys.EOS_ID, 2)
    w.add_kv(Keys.UNK_ID, 3)
    w.add_kv(Keys.PAD_ID, 0)

    def mat(name: str, out_d: int, in_d: int, t: GGMLType = weight_type):
        x = rng.normal(0.0, scale, size=(out_d, in_d)).astype(np.float32)
        w.add_tensor(name, numpy_ref.quantize(x, t), (out_d, in_d), t)

    def norm(name: str, d: int):
        # +1 baked in, as llama.cpp's Gemma converter does
        x = (1.0 + rng.normal(0.0, 0.02, size=(d,))).astype(np.float32)
        w.add_tensor(name, x, (d,), GGMLType.F32)

    mat("token_embd.weight", cfg.vocab_size, cfg.d_model)
    norm("output_norm.weight", cfg.d_model)
    for i in range(cfg.n_layers):
        mat(f"blk.{i}.attn_q.weight", cfg.q_dim, cfg.d_model)
        mat(f"blk.{i}.attn_k.weight", cfg.kv_dim, cfg.d_model)
        mat(f"blk.{i}.attn_v.weight", cfg.kv_dim, cfg.d_model)
        mat(f"blk.{i}.attn_output.weight", cfg.d_model, cfg.q_dim)
        mat(f"blk.{i}.ffn_gate.weight", cfg.d_ff, cfg.d_model)
        mat(f"blk.{i}.ffn_up.weight", cfg.d_ff, cfg.d_model)
        mat(f"blk.{i}.ffn_down.weight", cfg.d_model, cfg.d_ff)
        norm(f"blk.{i}.attn_norm.weight", cfg.d_model)
        norm(f"blk.{i}.ffn_norm.weight", cfg.d_model)
        if arch in ("gemma2", "gemma3"):  # sandwich norms
            norm(f"blk.{i}.post_attention_norm.weight", cfg.d_model)
            norm(f"blk.{i}.post_ffw_norm.weight", cfg.d_model)
        if arch == "gemma3":  # per-head QK-norm over head_dim
            norm(f"blk.{i}.attn_q_norm.weight", cfg.head_dim)
            norm(f"blk.{i}.attn_k_norm.weight", cfg.head_dim)
    w.write()
    return path
