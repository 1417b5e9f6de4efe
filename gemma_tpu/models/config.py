"""Model configuration, derived from GGUF metadata.

Replaces the reference's `hyper_param` struct + `init_hyper_param`
(`/root/reference/src/gemma_model.h:99-109`,
`/root/reference/src/gemma_model.cpp:403-415`). Unlike the reference — which
hardcodes `n_embd_kv_gqa = head_dim`, correct only for MQA Gemma-2B (see
SURVEY.md "quirks") — this derives the general GQA geometry, and reads
`attention.key_length` when present (Gemma-7B's head_dim=256 is NOT
n_embed/n_head).
"""
from __future__ import annotations

import dataclasses

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rms_eps: float = 1e-6
    rope_base: float = 10000.0
    context_length: int = 8192
    # Gemma-2/3 extensions (0 disables):
    sliding_window: int = 0
    # layer i uses the sliding window iff sliding_window > 0 and
    # i % swa_pattern != swa_pattern - 1 (gemma2: 2 -> even layers slide,
    # odd are global; gemma3: 6 -> five sliding then one global)
    swa_pattern: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # query scaling: attention logits are q·k * query_scale; Gemma uses
    # 1/sqrt(head_dim) (reference: gemma_model.cpp:708)
    query_scale: float | None = None
    # Gemma-3: sliding layers rope at a separate local base (0 = use
    # rope_base) while global layers scale positions by rope_scale
    # (= 1/rope.scaling.factor for linear scaling; 1.0 = none)
    rope_base_swa: float = 0.0
    rope_scale: float = 1.0
    # activation dtype: bf16 for serving; f32 for evaluation parity with
    # ggml's f32 activations (the Δppl gate, tools/ppl_gate.py)
    activation_dtype: str = "bfloat16"

    @property
    def act_dtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.activation_dtype)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a 2048 multiple. The embedding/head QTensor is
        zero-padded to this so the lm_head matmul splits into whole column
        slabs for any kernel tile up to 2048 wide; logits are sliced back
        to vocab_size."""
        return -(-self.vocab_size // 2048) * 2048

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def effective_query_scale(self) -> float:
        return self.query_scale if self.query_scale is not None else self.head_dim**-0.5

    def layer_window(self, layer_idx: int) -> int:
        """Sliding-window size for this layer (0 = global attention)."""
        if self.sliding_window <= 0 or self.swa_pattern <= 0:
            return 0
        if layer_idx % self.swa_pattern == self.swa_pattern - 1:
            return 0
        return self.sliding_window

    def layer_rope(self, layer_idx: int) -> tuple[float, float]:
        """(freq_base, position_scale) for this layer. Gemma-3 ropes sliding
        layers at the local base with no scaling; global layers use the
        trained base with linear position scaling (llama.cpp:
        `freq_base_l = is_swa ? base_swa : base`)."""
        if self.layer_window(layer_idx) > 0:
            return (self.rope_base_swa or self.rope_base, 1.0)
        return (self.rope_base, self.rope_scale)

    @classmethod
    def from_gguf(cls, reader: GGUFReader) -> "GemmaConfig":
        arch = reader.architecture
        kv = lambda key, default=None: reader.kv(key, default, arch=arch)
        d_model = int(kv(Keys.EMBEDDING_LENGTH))
        n_heads = int(kv(Keys.HEAD_COUNT))
        n_kv = int(kv(Keys.HEAD_COUNT_KV, n_heads))
        head_dim = int(kv(Keys.KEY_LENGTH, d_model // n_heads))
        embed = reader.tensors.get("token_embd.weight")
        vocab = embed.shape[0] if embed is not None else len(kv(Keys.TOKENS, []))
        # interleaved local/global attention cadence by family
        swa_pattern = {"gemma2": 2, "gemma3": 6}.get(arch, 0)
        rope_base_swa = float(kv(Keys.ROPE_FREQ_BASE_SWA, 0.0) or 0.0)
        if arch == "gemma3" and not rope_base_swa:
            rope_base_swa = 10000.0  # llama.cpp's gemma3 default local base
        factor = float(kv(Keys.ROPE_SCALING_FACTOR, 0.0) or 0.0)
        stype = kv(Keys.ROPE_SCALING_TYPE, "") or ""
        rope_scale = 1.0 / factor if (stype == "linear" and factor) else 1.0
        return cls(
            vocab_size=int(vocab),
            d_model=d_model,
            n_layers=int(kv(Keys.BLOCK_COUNT)),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=int(kv(Keys.FEED_FORWARD_LENGTH)),
            rms_eps=float(kv(Keys.RMS_EPS, 1e-6)),
            rope_base=float(kv(Keys.ROPE_FREQ_BASE, 10000.0)),
            context_length=int(kv(Keys.CONTEXT_LENGTH, 8192)),
            sliding_window=int(kv(Keys.SLIDING_WINDOW, 0) or 0),
            swa_pattern=swa_pattern,
            attn_softcap=float(kv(Keys.ATTN_SOFTCAP, 0.0) or 0.0),
            final_softcap=float(kv(Keys.LOGIT_SOFTCAP, 0.0) or 0.0),
            rope_base_swa=rope_base_swa,
            rope_scale=rope_scale,
        )


# Canonical architectures, for fabricating models and sanity checks.
GEMMA_2B = GemmaConfig(
    vocab_size=256000, d_model=2048, n_layers=18, n_heads=8, n_kv_heads=1,
    head_dim=256, d_ff=16384, context_length=8192,
)
GEMMA_7B = GemmaConfig(
    vocab_size=256000, d_model=3072, n_layers=28, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, context_length=8192,
)
