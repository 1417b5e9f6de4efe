"""Fused dequant + matmul for block-quantized weights (Pallas, Triton route).

The hot op of the framework: the reference spends 99.49 % of its runtime in
the equivalent `hpc.cpp:216 mul_mat` + `kernals.cl` vec-dot kernels
(BASELINE.md). At batch-1 decode the weights are nearly all of a step's
bytes, so the kernel reads them once, in the packed device layout of
quant/qtensor.py, and dequantizes in registers: no dequantized copy of a
weight ever reaches device memory.

Design, for a GPU whose blocks run in parallel on many SMs:

* grid ``(M/bm, N/bn, splits)``: a program owns a ``bn``-column slab and one
  of ``splits`` contiguous K ranges, and loops over its range in tiles of
  ``_SB_PER_TILE`` 256-element superblocks with an f32 accumulator in
  registers. Shapes with few column slabs (qkv, attn_out, ffn_down at
  decode) split K so that enough programs fill the card; XLA adds the
  splits' partial sums afterwards;
* 4-bit payloads pair K elements 2k (low nibble) and 2k+1 (high nibble) in
  one byte. The activations are split into their even and odd columns
  outside the kernel, so each nibble plane is a plain [K/2, bn] matrix:
  ``y = x_even @ W_lo + x_odd @ W_hi``. Nibbles sign-extend by two shifts;
* scales widen to f32 and multiply in f32; the dequantized tile narrows to
  bf16 for the tensor-core dot, which accumulates in f32. ``pl.dot`` needs
  16 rows, so M pads to at least 16.

Every array is reshaped (a free view) so that each load is a power-of-two
block, as the Triton route requires. Rows of M beyond ``KERNEL_MAX_M`` take
the plain path, dequantize + cuBLAS, which wins once the matmul is
compute-bound (PERF.md has the measurement). The plain path is also the
reference the kernels are tested against.
"""
from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..quant.qtensor import QTensor, dequant_t
from . import _backend

# Largest M (rows of x) that runs the kernel; larger M runs dequant + cuBLAS.
KERNEL_MAX_M = 64
_MIN_M = 16  # pl.dot's least row count
_SB = 256  # superblock: the K granule every format's metadata repeats at
_SB_PER_TILE = 1  # superblocks per K tile of the inner loop
_BN = 128  # output columns per program (64 and 32 measured slower, PERF.md)
_TARGET_PROGRAMS = 264  # two programs per SM of an H100 before splitting K
_NUM_WARPS = 4
_NUM_STAGES = 3

_FORMATS = ("q4_0", "q8_0", "q4_k", "q6_k")


def _sext4(q: jax.Array, hi: bool) -> jax.Array:
    """Signed 4-bit field of an int32 holding one byte (low or high nibble)."""
    return (q << (24 if hi else 28)) >> 28


def _bf16(w: jax.Array) -> jax.Array:
    """[G, r, bn] f32 tile -> [G*r, bn] bf16 dot operand."""
    G, r, bn = w.shape
    return w.astype(jnp.bfloat16).reshape(G * r, bn)


# ---------------------------------------------------------------------------
# Per-format tile dequantization. Each returns the bf16 weight planes of the
# K tile starting at superblock `sb`, in the order of the activation planes.
# ---------------------------------------------------------------------------

def _planes_q4_0(refs, sb, cols, T):
    qs_ref, sc_ref = refs  # [K/32, 16, N] u8, [K/32, N] bf16
    g = pl.ds(sb * 8, 8 * T)
    q = qs_ref[g, :, cols].astype(jnp.int32)  # [8T, 16, bn]
    sc = sc_ref[g, cols].astype(jnp.float32)[:, None, :]
    return [
        _bf16(_sext4(q, False).astype(jnp.float32) * sc),
        _bf16(_sext4(q, True).astype(jnp.float32) * sc),
    ]


def _planes_q8_0(refs, sb, cols, T):
    qs_ref, sc_ref = refs  # [K/32, 32, N] i8, [K/32, N] bf16
    g = pl.ds(sb * 8, 8 * T)
    q = qs_ref[g, :, cols].astype(jnp.float32)  # [8T, 32, bn]
    sc = sc_ref[g, cols].astype(jnp.float32)[:, None, :]
    return [_bf16(q * sc)]


def _bf16_bits(lo: jax.Array, hi: jax.Array) -> jax.Array:
    """bf16 value whose low and high bytes are the int8 values lo, hi."""
    bits = ((hi.astype(jnp.int32) & 0xFF) << 8) | (lo.astype(jnp.int32) & 0xFF)
    return jax.lax.bitcast_convert_type(
        bits.astype(jnp.int16), jnp.bfloat16
    ).astype(jnp.float32)


def _per_group(v: jax.Array, r: int) -> jax.Array:
    """[T, bn] per-superblock value -> [T*r, bn], repeated r times."""
    T, bn = v.shape
    return jnp.broadcast_to(v[:, None, :], (T, r, bn)).reshape(T * r, bn)


def _planes_q4_k(refs, sb, cols, T):
    # w = sc*q + (8sc - mn), q the stored signed nibble (ggml q - 8),
    # sc = d*sc6 and mn = dmin*mn6 per 32 elements, from the exact int8
    # sub-scales and the exact bf16 hi/lo pairs of d and dmin
    qs_ref, meta_ref = refs  # [K/32, 16, N] u8, [K/256, 24, N] i8
    sbs = pl.ds(sb, T)
    sc6 = meta_ref[sbs, pl.ds(0, 8), cols].astype(jnp.float32).reshape(8 * T, -1)
    mn6 = meta_ref[sbs, pl.ds(8, 8), cols].astype(jnp.float32).reshape(8 * T, -1)

    def quad(j):  # j-th bf16 of [d_hi, dmin_hi, d_lo, dmin_lo]
        return _bf16_bits(meta_ref[sbs, 16 + j, cols], meta_ref[sbs, 20 + j, cols])

    d = _per_group(quad(0) + quad(2), 8)
    dmin = _per_group(quad(1) + quad(3), 8)
    sc = (sc6 * d)[:, None, :]
    offs = (8.0 * sc6 * d - mn6 * dmin)[:, None, :]
    q = qs_ref[pl.ds(sb * 8, 8 * T), :, cols].astype(jnp.int32)  # [8T, 16, bn]
    return [
        _bf16(_sext4(q, False).astype(jnp.float32) * sc + offs),
        _bf16(_sext4(q, True).astype(jnp.float32) * sc + offs),
    ]


def _planes_q6_k(refs, sb, cols, T):
    # q = s4 + 16*hi2 - 24 (exact integers); w = q * d * sc8 per 16 elements.
    # Even element 2r of a superblock (r = 32i + m) keeps its 2-bit field in
    # bits 2i of qh byte row 2m, the odd element 2r+1 in row 2m+1.
    ql_ref, qh_ref, sc8_ref, d_ref = refs
    # [K/16, 8, N] u8, [K/256, 32, 2, N] u8, [K/16, N] i8, [K/256, 4, N] bf16
    sbs = pl.ds(sb, T)
    d = d_ref[sbs, 0, cols].astype(jnp.float32) + d_ref[sbs, 1, cols].astype(jnp.float32)
    sc = (sc8_ref[pl.ds(sb * 16, 16 * T), cols].astype(jnp.float32) * _per_group(d, 16))
    sc = sc[:, None, :]  # [16T, 1, bn]
    q = ql_ref[pl.ds(sb * 16, 16 * T), :, cols].astype(jnp.int32)  # [16T, 8, bn]
    shift = 2 * jax.lax.broadcasted_iota(jnp.int32, (1, 4, 1, 1), 1)
    planes = []
    for odd in (False, True):
        qh = qh_ref[sbs, :, int(odd), cols].astype(jnp.int32)  # [T, 32, bn]
        hi2 = (qh[:, None, :, :] >> shift) & 3  # [T, 4, 32, bn]
        bn = hi2.shape[-1]
        hi2 = hi2.reshape(16 * T, 8, bn)
        v = _sext4(q, odd) + 16 * hi2 - 24
        planes.append(_bf16(v.astype(jnp.float32) * sc))
    return planes


def _views(qt: QTensor) -> list[jax.Array]:
    """Free reshapes of the device arrays into the kernels' block views."""
    N, K = qt.shape
    a = qt.arrays
    if qt.fmt == "q4_0":
        return [a["qs"].reshape(K // 32, 16, N), a["scales"]]
    if qt.fmt == "q8_0":
        return [a["qs"].reshape(K // 32, 32, N), a["scales"]]
    if qt.fmt == "q4_k":
        return [a["qs"].reshape(K // 32, 16, N), a["meta"].reshape(K // _SB, 24, N)]
    if qt.fmt == "q6_k":
        return [
            a["ql"].reshape(K // 16, 8, N),
            a["qh"].reshape(K // _SB, 32, 2, N),
            a["sc8"],
            a["d"].reshape(K // _SB, 4, N),
        ]
    raise NotImplementedError(qt.fmt)


_PLANES = {
    "q4_0": _planes_q4_0,
    "q8_0": _planes_q8_0,
    "q4_k": _planes_q4_k,
    "q6_k": _planes_q6_k,
}


def _kernel(*refs, fmt, n_x, bm, bn, n_iter, m_true):
    x_refs = refs[:n_x]
    w_refs = refs[n_x:-1]
    o_ref = refs[-1]
    m, n, s = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    rows = pl.ds(m * bm, bm)
    cols = pl.ds(n * bn, bn)
    T = _SB_PER_TILE
    kx = T * _SB // n_x  # columns of each activation plane per K tile

    def body(i, acc):
        sb = (s * n_iter + i) * T
        planes = _PLANES[fmt](w_refs, sb, cols, T)
        for x_ref, w in zip(x_refs, planes):
            acc += pl.dot(x_ref[rows, pl.ds(sb * _SB // n_x, kx)], w)
        return acc

    acc = jax.lax.fori_loop(0, n_iter, body, jnp.zeros((bm, bn), jnp.float32))
    row_ids = m * bm + jax.lax.broadcasted_iota(jnp.int32, (bm, bn), 0)
    plgpu.store(o_ref.at[s, rows, cols], acc, mask=row_ids < m_true)


def _split_count(n_blocks: int, n_tiles: int) -> int:
    """K splits: the largest power of two that keeps the program count near
    _TARGET_PROGRAMS and divides the K tiles evenly."""
    s = 1
    while (
        n_blocks * s * 2 <= _TARGET_PROGRAMS
        and n_tiles % (s * 2) == 0
    ):
        s *= 2
    return s


@functools.partial(jax.jit, static_argnames=("fmt", "interpret"))
def _qmm_call(x2d, views, fmt, interpret):
    M, K = x2d.shape
    N = views[0].shape[-1]
    bm = _MIN_M
    while bm < min(M, KERNEL_MAX_M):
        bm *= 2
    Mp = -(-M // bm) * bm
    x = jnp.pad(x2d.astype(jnp.bfloat16), ((0, Mp - M), (0, 0)))
    xs = [x] if fmt == "q8_0" else [x[:, 0::2], x[:, 1::2]]
    n_tiles = K // (_SB * _SB_PER_TILE)
    n_blocks = (Mp // bm) * (N // _BN)
    splits = _split_count(n_blocks, n_tiles)
    kernel = functools.partial(
        _kernel, fmt=fmt, n_x=len(xs), bm=bm, bn=_BN,
        n_iter=n_tiles // splits, m_true=M,
    )
    part = pl.pallas_call(
        kernel,
        grid=(Mp // bm, N // _BN, splits),
        out_shape=jax.ShapeDtypeStruct((splits, Mp, N), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name=f"qmm_{fmt}",
    )(*xs, *views)
    return part[:, :M].sum(axis=0)


def tiles(qt: QTensor) -> bool:
    """Shapes the kernel takes: whole superblock tiles along K and whole
    column slabs along N (any M; the dispatch adds the M threshold)."""
    N, K = qt.shape
    return qt.fmt in _PLANES and K % (_SB * _SB_PER_TILE) == 0 and N % _BN == 0


def supports(x_shape: tuple[int, ...], qt: QTensor) -> bool:
    """Whether matmul() takes the kernel: the weight tiles and M (rows of
    x) is at most KERNEL_MAX_M."""
    M = 1
    for d in x_shape[:-1]:
        M *= d
    return tiles(qt) and M <= KERNEL_MAX_M


def quant_matmul(x: jax.Array, qt: QTensor) -> jax.Array:
    """y = x @ dequant(qt).T through the kernel; x [..., K] -> y [..., N] f32."""
    N, K = qt.shape
    *lead, _ = x.shape
    out = _qmm_call(x.reshape(-1, K), _views(qt), qt.fmt, _backend.interpret())
    return out.reshape(*lead, N)


def plain_matmul(x: jax.Array, qt: QTensor) -> jax.Array:
    """The plain path: dequantize, then one XLA dot. f32 activations are
    the evaluation-precision mode (the Δppl gate): dequantize in f32 and
    multiply at full f32 precision, ggml's own arithmetic."""
    if x.dtype == jnp.float32:
        return jnp.dot(
            x, dequant_t(qt, jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return jnp.dot(x, dequant_t(qt, jnp.bfloat16), preferred_element_type=jnp.float32)


_WARNED: set[tuple[str, tuple[int, int]]] = set()


def matmul(x: jax.Array, qt: QTensor) -> tuple[jax.Array, str]:
    """x @ dequant(qt).T by the kernel where it runs and the shape tiles,
    by the plain path otherwise. Returns (y f32, the path taken)."""
    if x.dtype == jnp.float32 or not _backend.use_kernels("matmul"):
        return plain_matmul(x, qt), "plain"
    if not tiles(qt):
        if (qt.fmt, qt.shape) not in _WARNED:
            _WARNED.add((qt.fmt, qt.shape))
            warnings.warn(
                f"QTensor {qt.fmt}{list(qt.shape)} does not tile for the "
                f"kernel (K % {_SB}, N % {_BN}); using dequant + dot",
                stacklevel=3,
            )
        return plain_matmul(x, qt), "plain"
    if not supports(x.shape, qt):  # prefill M: dequant + cuBLAS wins
        return plain_matmul(x, qt), "plain"
    return quant_matmul(x, qt), "kernel"
