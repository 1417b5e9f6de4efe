"""Device-layout QTensor: conversion + XLA dequant must match the numpy
reference (bit-exact in f32, up to the bf16 output cast)."""
import numpy as np
import pytest

from gemma_tpu.quant import numpy_ref
from gemma_tpu.quant.qtensor import GGML_TO_FMT, dequant, from_ggml, quantize_array

SHAPES = {"q4_0": (16, 128), "q8_0": (16, 96), "q4_k": (8, 512), "q6_k": (8, 512)}


@pytest.mark.parametrize("fmt", sorted(SHAPES))
def test_device_dequant_matches_reference(fmt, rng):
    ggml_type = next(t for t, f in GGML_TO_FMT.items() if f == fmt)
    shape = SHAPES[fmt]
    x = rng.normal(size=shape).astype(np.float32)
    raw = numpy_ref.quantize(x, ggml_type)
    ref = numpy_ref.dequantize(raw, ggml_type, shape)

    qt = from_ggml(raw, ggml_type, shape)
    dev = np.asarray(dequant(qt, dtype=np.float32))
    # layout v4 stores scales as bf16(f16 value): one extra rounding of
    # <= 2^-9 relative on the scale (q values themselves are exact), two
    # orders below the 4-bit quantization noise. K-quants add the d*sc
    # f16 fold (<= 2^-11).
    np.testing.assert_allclose(dev, ref, rtol=5e-3, atol=5e-3 * np.abs(ref).max())
    # and the bf16 scale grid is DETERMINISTIC: re-converting is bit-equal
    qt2 = from_ggml(raw, ggml_type, shape)
    np.testing.assert_array_equal(dev, np.asarray(dequant(qt2, dtype=np.float32)))


def test_quantize_array_roundtrip(rng):
    x = rng.normal(size=(8, 256)).astype(np.float32)
    qt = quantize_array(x, "q4_k")
    y = np.asarray(dequant(qt, dtype=np.float32))
    rms = np.sqrt(np.mean((x - y) ** 2)) / np.sqrt(np.mean(x**2))
    assert rms < 0.09


def test_qtensor_is_pytree(rng):
    import jax

    x = rng.normal(size=(4, 64)).astype(np.float32)
    qt = quantize_array(x, "q4_0")
    leaves, treedef = jax.tree_util.tree_flatten(qt)
    qt2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert qt2.fmt == "q4_0" and qt2.shape == (4, 64)
    np.testing.assert_array_equal(
        np.asarray(dequant(qt, np.float32)), np.asarray(dequant(qt2, np.float32))
    )


def test_nbytes_budget(rng):
    # Q4_0 device layout v4: 4-bit nibbles + bf16 group scales = 4.5
    # bits/weight — exactly ggml's wire density (decode is HBM-bound, so
    # metadata width is stream time; see qtensor.py docstring).
    x = rng.normal(size=(64, 4096)).astype(np.float32)
    qt = quantize_array(x, "q4_0")
    bits_per_weight = qt.nbytes() * 8 / x.size
    assert bits_per_weight == pytest.approx(4.5, abs=0.01)
