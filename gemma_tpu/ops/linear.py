"""Linear / matmul dispatch.

All model projections route through :func:`linear`, so quantized weights
are served by the fused dequant+matmul kernels of ops.quant_matmul where
those run, and by XLA's dequantize-then-dot elsewhere. Where the reference
picks CPU-vs-iGPU per call with a static 0.9 row split
(`hpc.cpp:245-248`), here the choice is per backend and per shape
(quant_matmul.matmul).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..quant.qtensor import QTensor
from . import quant_matmul


def _trace_count(x: jax.Array, w, path: str) -> None:
    """Op-shape histogram, recorded at TRACE time (once per compiled graph)
    — the analogue of the reference's per-dispatch add_count histograms
    (`/root/reference/src/hpc.cpp:236-243`); per-execution timing lives in
    the engine's roofline records."""
    from ..utils import profiling

    if not profiling.is_enabled():
        return
    m = 1
    for d in x.shape[:-1]:
        m *= d
    if isinstance(w, QTensor):
        shape, fmt = w.shape, w.fmt
    else:
        shape, fmt = tuple(w.shape), str(w.dtype)
    profiling.add_count(f"trace.matmul.{path}.{fmt}[{shape[0]}x{shape[1]}]xM{m}")


def linear(x: jax.Array, w, *, out_dtype=None) -> jax.Array:
    """y = x @ w.T for w either a dense [out, in] array or a QTensor.

    x: [..., in]; returns [..., out] in x.dtype (or out_dtype). f32
    activations (the evaluation-precision mode) multiply at full f32
    precision, not TF32.
    """
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        y, path = quant_matmul.matmul(x, w)
        _trace_count(x, w, path)
        return y.astype(out_dtype)
    _trace_count(x, w, "dense")
    precision = jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    return jnp.dot(
        x, w.T, preferred_element_type=jnp.float32, precision=precision
    ).astype(out_dtype)
