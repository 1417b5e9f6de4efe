"""On-device kernel verification: the kernel path against the plain path.

The reference cross-checks its offloaded kernels element-wise against the
CPU result DURING real runs (`/root/reference/src/kernals.cl:203-213,
254-264, 305-315` — the GPU matmuls verify every value and printf
mismatches). Interpret-mode CI catches logic bugs but not what the GPU's
compiler makes of a kernel: a toolchain upgrade could silently change what
the compiled kernel computes. This module is the analogue of the
reference's in-situ check — run one prefill + N greedy decode steps twice
on the SAME device, once through the kernels (Pallas decode attention and
quantized matmuls, cuDNN prefill attention) and once through the plain XLA
path (ops._backend.plain_path), replaying the kernel path's token stream
into the plain path so the comparison is step-for-step on identical
inputs, and report the max |Δ| per step.

Exposed as `--verify` on the CLI generate/bench/serve subcommands.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def verify_device_kernels(
    cfg,
    params,
    prompt: list[int],
    n_decode: int = 4,
    max_seq_len: int = 512,
    kv_quantized: bool = False,
    paged: bool = False,
    page_size: int = 64,
    atol: float = 0.05,
) -> dict[str, Any]:
    """Compare the kernel and plain forward passes on-device.

    Returns {"ok": bool, "max_abs": float, "steps": [per-step max |Δ| of
    the full logits vector], "argmax_agree": bool, "argmax_within_atol":
    bool}. Tolerance: both paths compute f32 logits from the same
    bf16-dequantized weights and differ only in accumulation order and in
    where softmax weights round to bf16, so |Δ| is small but not zero —
    default atol 0.05 on logits of O(10). The argmax check allows a near
    tie: the plain path must rate the kernel path's argmax within atol of
    its own maximum."""
    import jax.numpy as jnp

    from ..ops import _backend
    from ..runtime import Engine, EngineConfig

    ecfg = EngineConfig(
        max_seq_len=max_seq_len, max_batch=1, donate_cache=False,
        kv_quantized=kv_quantized, paged=paged, page_size=page_size,
    )

    def run(tokens: list[int] | None):
        """One prefill + n_decode steps. tokens=None: greedy (records the
        stream); else replay the given stream."""
        eng = Engine(cfg, params, ecfg)
        logits, cache = eng.prefill([prompt])
        outs = [np.asarray(logits[0])]
        stream: list[int] = []
        for i in range(n_decode):
            t = int(np.argmax(outs[-1])) if tokens is None else tokens[i]
            stream.append(t)
            logits, cache = eng.decode_step(jnp.asarray([t], jnp.int32), cache)
            outs.append(np.asarray(logits[0]))
        return outs, stream

    kernel_outs, stream = run(None)
    with _backend.plain_path():
        ref_outs, _ = run(stream)

    steps = [float(np.abs(a - b).max()) for a, b in zip(kernel_outs, ref_outs)]
    argmax_agree = all(
        int(np.argmax(a)) == int(np.argmax(b))
        for a, b in zip(kernel_outs, ref_outs)
    )
    within = all(
        float(b[int(np.argmax(a))]) >= float(b.max()) - atol
        for a, b in zip(kernel_outs, ref_outs)
    )
    max_abs = max(steps)
    return {
        "ok": bool(max_abs <= atol and within),
        "max_abs": max_abs,
        "steps": steps,
        "argmax_agree": argmax_agree,
        "argmax_within_atol": within,
        "n_decode": n_decode,
        "atol": atol,
    }


def format_report(res: dict[str, Any]) -> str:
    lines = [
        f"kernel-vs-plain on-device verification: "
        f"{'OK' if res['ok'] else 'MISMATCH'}",
        f"  max |dlogit| over prefill + {res['n_decode']} decode steps: "
        f"{res['max_abs']:.3g} (atol {res['atol']})",
        f"  argmax agreement: {res['argmax_agree']} "
        f"(within atol: {res['argmax_within_atol']})",
        "  per-step max |d|: " + ", ".join(f"{s:.3g}" for s in res["steps"]),
    ]
    return "\n".join(lines)
