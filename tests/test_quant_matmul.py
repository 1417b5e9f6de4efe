"""Fused dequant+matmul kernels vs the XLA dequant reference.

Runs the Triton-route Pallas kernels in interpret mode on the CPU (the same
kernel code the GPU compiles); each kernel must match x @ dequant(w).T to
bf16-level tolerance. The dispatch around them (shapes, padding, split-K,
the M threshold) is checked here too.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gemma_tpu.ops import _backend
from gemma_tpu.ops import quant_matmul as qm
from gemma_tpu.ops.quant_matmul import matmul, plain_matmul, quant_matmul, supports
from gemma_tpu.quant.qtensor import dequant, quantize_array

CASES = [
    ("q4_0", (256, 512), 1),
    ("q4_0", (256, 512), 7),
    ("q4_0", (128, 1024), 64),
    ("q8_0", (256, 512), 1),
    ("q8_0", (128, 512), 33),
    # K-quants: whole 256-element superblocks per K tile
    ("q4_k", (256, 1024), 1),
    ("q4_k", (128, 1024), 16),
    ("q6_k", (256, 1024), 1),
    ("q6_k", (128, 1024), 9),
    # wide N: many column slabs, no K split
    ("q4_0", (8192, 512), 1),
    ("q4_0", (16384, 512), 1),
]


@pytest.mark.parametrize("fmt,shape,m", CASES, ids=[f"{f}-{s}-m{m}" for f, s, m in CASES])
def test_kernel_matches_dequant_reference(fmt, shape, m, rng, interpret_kernels):
    N, K = shape
    w = quantize_array(rng.normal(size=(N, K)).astype(np.float32), fmt)
    x = jnp.asarray(rng.normal(size=(m, K)).astype(np.float32), jnp.bfloat16)
    assert supports(x.shape, w)

    got = np.asarray(quant_matmul(x, w))
    ref = np.asarray(
        jnp.dot(x, dequant(w, jnp.bfloat16).T, preferred_element_type=jnp.float32)
    )
    # bf16 weight rounding differs slightly between paths (kernel rounds
    # after scale multiply); tolerance ~ bf16 eps * sqrt(K) * |x||w|
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got, ref, atol=2e-2 * scale, rtol=2e-2)


def test_batched_leading_dims(rng, interpret_kernels):
    w = quantize_array(rng.normal(size=(128, 512)).astype(np.float32), "q4_0")
    x = jnp.asarray(rng.normal(size=(2, 3, 512)), jnp.bfloat16)
    y = quant_matmul(x, w)
    assert y.shape == (2, 3, 128)
    y2 = quant_matmul(x.reshape(6, 512), w).reshape(2, 3, 128)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2), rtol=1e-6)


def test_supports_gating(rng):
    w = quantize_array(rng.normal(size=(100, 96)).astype(np.float32), "q4_0")
    assert not supports((1, 96), w)  # K not a superblock multiple, N not a slab
    w = quantize_array(rng.normal(size=(96, 256)).astype(np.float32), "q4_0")
    assert not supports((1, 256), w)  # N=96 not a whole column slab
    w = quantize_array(rng.normal(size=(128, 256)).astype(np.float32), "q4_0")
    assert supports((qm.KERNEL_MAX_M, 256), w)
    assert not supports((qm.KERNEL_MAX_M + 1, 256), w)  # prefill M: plain


@pytest.mark.parametrize("n_blocks,n_tiles,want", [
    (16, 64, 16),   # ffn_down-like: few slabs, deep K -> split K
    (20, 8, 8),     # qkv-like: split capped by the K tiles
    (512, 8, 1),    # gate_up-like: enough slabs already
    (4000, 8, 1),   # lm_head-like
    (33, 6, 2),     # the split must divide the K tiles
])
def test_split_count(n_blocks, n_tiles, want):
    s = qm._split_count(n_blocks, n_tiles)
    assert s == want
    assert n_tiles % s == 0


def test_dispatch_paths(rng, interpret_kernels):
    """matmul() takes the kernel where it runs and the shape tiles, and the
    plain path for prefill M, f32 activations and under plain_path()."""
    w = quantize_array(rng.normal(size=(128, 256)).astype(np.float32), "q4_0")
    x = jnp.asarray(rng.normal(size=(1, 256)), jnp.bfloat16)
    assert matmul(x, w)[1] == "kernel"
    big = jnp.asarray(rng.normal(size=(qm.KERNEL_MAX_M + 1, 256)), jnp.bfloat16)
    assert matmul(big, w)[1] == "plain"
    assert matmul(x.astype(jnp.float32), w)[1] == "plain"
    with _backend.plain_path():
        assert matmul(x, w)[1] == "plain"


def test_no_kernels_without_the_hook(rng):
    """On the CPU without the interpret hook every matmul is plain."""
    w = quantize_array(rng.normal(size=(64, 256)).astype(np.float32), "q4_0")
    x = jnp.asarray(rng.normal(size=(1, 256)), jnp.bfloat16)
    y, path = matmul(x, w)
    assert path == "plain"
    np.testing.assert_array_equal(np.asarray(y), np.asarray(plain_matmul(x, w)))


def test_f32_plain_path_is_full_precision(rng):
    """The evaluation mode (f32 activations) multiplies at HIGHEST
    precision: it matches a float64 numpy product to f32 rounding."""
    w = quantize_array(rng.normal(size=(64, 256)).astype(np.float32), "q8_0")
    x = rng.normal(size=(3, 256)).astype(np.float32)
    got = np.asarray(plain_matmul(jnp.asarray(x), w))
    ref = x.astype(np.float64) @ np.asarray(dequant(w, jnp.float32), np.float64).T
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
