"""gemma_tpu — a quantized Gemma inference framework in JAX, for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
`geraltigas/gemma.ggml` engine (see SURVEY.md): GGUF block-quantized
checkpoint loading, Gemma decoder forward (RoPE/GQA/GeGLU, tied head),
prefill + sampling decode over a KV-cache, golden-tensor differential
testing, and op-level performance profiling — rebuilt on JAX: fused
dequant+matmul and decode-attention kernels (Pallas, Triton route), cuDNN
prefill attention, jitted decode graphs with continuous batching, and
mesh-sharded multi-device execution.
"""

__version__ = "0.1.0"

from . import gguf, quant  # noqa: F401
