"""QTensor — block-quantized tensors in device layout.

The reference keeps ggml's interleaved block bytes in host memory and decodes
them scalar-by-scalar inside `vec_dot` (`/root/reference/src/hpc.cpp:33-37`,
`/root/reference/src/kernals.cl:48-156`). Here checkpoints are re-laid-out
**once at load time** into a K-major structure-of-arrays form read by the
fused dequant+matmul kernel (ops/quant_matmul.py) and by XLA's
dequantize-then-dot:

* all arrays are **[K-granule, N]** — K (reduction/in-features) first, N
  (out-features) last and contiguous, so a kernel tile of bn output
  columns reads contiguous runs of every array, and the dot is the plain
  ``x @ W`` (no transposed contraction);
* 4-bit payloads are stored as **K-paired signed nibbles**: byte[k', n]
  packs elements 2k' (low nibble) and 2k'+1 (high), two's-complement, with
  the ggml zero-point already folded (q4_0/q4_k store q-8). The kernel
  multiplies each nibble plane by the even or odd activations and
  sign-extends a nibble with two shifts;
* per-group metadata: decode tokens/s is bound by device-memory bandwidth
  and metadata is pure stream bytes, so metadata width is decode time.
  q4_0/q8_0 store their per-32 f16 scale rounded to **bf16** (one widening
  convert in the kernel; q4_0 lands on 4.5 bpw, exactly ggml's wire
  density). K-quants keep ggml's 6-bit/int8 sub-scales as EXACT int8
  arrays and store the per-256-superblock f16 d (dmin) as an EXACT bf16
  hi/lo pair (see ``_hi_lo``); the kernel reconstructs d = hi + lo and
  computes effective scales d*sc in f32 — **bit-identical dequant to
  ggml** at 4.75 bpw. The cheaper-looking alternatives both failed the ppl
  gate: one bf16 folded scale+offset rounds the per-group affine offset, a
  *bias* (+0.37 ppl), and a single-bf16 d/dmin biases via the min term,
  which is ~8x the scale term (+0.64 ppl).

Device formats (logical tensor is [N, K] = [out, in], ggml row-major);
ggml wire bpw for comparison: q4_0 4.5, q8_0 8.5, q4_k 4.5, q6_k 6.5625:

====== ============================================================ ======
fmt    arrays                                                        bpw
====== ============================================================ ======
q4_0   qs u8 [K/2, N] (signed q-8 pairs), scales bf16 [K/32, N]      4.5
q8_0   qs i8 [K, N],   scales bf16 [K/32, N]                         8.5
q4_k   qs u8 [K/2, N] (signed q-8 pairs), meta i8 [3K/32, N]
       (24 rows/superblock: 8 sc6, 8 mn6, 4 lo + 4 hi bytes of
       the bf16 [d_hi, dmin_hi, d_lo, dmin_lo] quad)                 4.75
q6_k   ql u8 [K/2, N] (signed nibble pairs of (u&15)-8, u = q+32),
       qh u8 [K/4, N] (plane-major 2-bit fields of u>>4),
       sc8 i8 [K/16, N], d bf16 [K/64, N] (hi/lo pairs)              6.75
====== ============================================================ ======
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..gguf.constants import GGMLType
from . import numpy_ref

QGROUP = 32  # fine-grain scale group (ggml QK4_0/QK8_0 block size)
# Scales are ggml f16 values rounded to bf16 at load (see module docstring;
# ml_dtypes supplies numpy-side bf16).
import ml_dtypes  # noqa: E402  (jax dependency, always present)

SCALE_DTYPE = ml_dtypes.bfloat16


def store_f16(x: np.ndarray) -> np.ndarray:
    """Round to ggml's f16 scale grid, then to the bf16 storage grid."""
    return np.ascontiguousarray(x.astype(np.float16).astype(SCALE_DTYPE))


def _hi_lo(x16: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split f16 values into an EXACT bf16 (hi, lo) pair: hi = bf16(x),
    lo = bf16(x - hi). f16 has 11 mantissa bits; hi captures 8 and the
    residual has <= 3 significant bits, so lo is exact and hi + lo == x
    bit-for-bit in f32. Lets K-quant superblock d/dmin ride bf16 arrays
    with zero precision loss (a single bf16 dmin measured +0.64 ppl on the
    gate model — the min term is a per-group *bias* ~8x the scale term)."""
    x32 = x16.astype(np.float32)
    hi = x32.astype(SCALE_DTYPE)
    lo = (x32 - hi.astype(np.float32)).astype(SCALE_DTYPE)
    return hi, lo


# payload array + K-rows-per-payload-row, per format (shape derivation)
_PAYLOAD = {
    "q4_0": ("qs", 2),
    "q8_0": ("qs", 1),
    "q4_k": ("qs", 2),
    "q6_k": ("ql", 2),
}


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QTensor:
    """A logical [N, K] = [out, in] quantized matrix in device layout."""

    fmt: str  # static: 'q4_0' | 'q8_0' | 'q4_k' | 'q6_k'
    arrays: dict[str, Any]  # device arrays, all [K-granule, N]

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (N, K), derived from the payload array so it stays
        correct for shard-local views inside shard_map (static aux data
        would go stale when the leaves are sliced)."""
        key, mult = _PAYLOAD[self.fmt]
        a = self.arrays[key]
        return (int(a.shape[1]), int(a.shape[0]) * mult)

    def tree_flatten(self):
        keys = tuple(sorted(self.arrays))
        return tuple(self.arrays[k] for k in keys), (self.fmt, keys)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fmt, keys = aux
        return cls(fmt, dict(zip(keys, children)))

    @property
    def dtype(self):  # logical dtype after dequant
        return jnp.bfloat16

    def nbytes(self) -> int:
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in self.arrays.values())


# ---------------------------------------------------------------------------
# Host-side conversion: ggml payload -> device layout (numpy)
# ---------------------------------------------------------------------------

def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _pack_signed_pairs(vals: np.ndarray) -> np.ndarray:
    """[K, N] int values in [-8, 7] -> u8 [K/2, N] nibble pairs (element 2k'
    in the low nibble)."""
    v = vals.astype(np.int8) & 0xF
    return (v[0::2] | (v[1::2] << 4)).astype(np.uint8)


def pack_q4_0(raw, shape) -> dict[str, np.ndarray]:
    rows, cols = shape  # (N, K)
    b = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, cols // 32, 18)
    scales = b[:, :, :2].copy().view("<f2").reshape(rows, cols // 32)
    nib = b[:, :, 2:]  # ggml order: element j<16 = lo nibble of byte j, else hi
    q = np.concatenate([nib & 0x0F, nib >> 4], axis=2).reshape(rows, cols)
    q = q.astype(np.int8) - 8  # zero-point folded into the signed payload
    return {"qs": _pack_signed_pairs(_t(q)), "scales": store_f16(_t(scales))}


def pack_q8_0(raw, shape) -> dict[str, np.ndarray]:
    rows, cols = shape
    b = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, cols // 32, 34)
    scales = b[:, :, :2].copy().view("<f2").reshape(rows, cols // 32)
    qs = b[:, :, 2:].view(np.int8).reshape(rows, cols)
    return {"qs": _t(qs), "scales": store_f16(_t(scales))}


def pack_q4_k(raw, shape) -> dict[str, np.ndarray]:
    # K-quant metadata: ggml's 6-bit sub-scales/mins stay EXACT int8
    # arrays; only the per-superblock f16 d/dmin round to bf16. Folding
    # d*sc into one bf16 effective scale would make the per-32 affine
    # offset a bf16-rounded *bias* — measured +0.37 ppl on the gate model.
    # Exact ints + exact bf16 hi/lo superscales reproduce ggml's dequant
    # bit for bit at 4.75 bpw.
    rows, cols = shape
    nsb = cols // 256
    b = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, nsb, 144)
    d = b[:, :, 0:2].copy().view("<f2").reshape(rows, nsb)
    dmin = b[:, :, 2:4].copy().view("<f2").reshape(rows, nsb)
    sc6, mn6 = numpy_ref._unpack_scale_min_k4(b[:, :, 4:16].reshape(-1, 12))
    sc6 = sc6.reshape(rows, nsb, 8).astype(np.int8)  # 0..63, exact
    mn6 = mn6.reshape(rows, nsb, 8).astype(np.int8)
    # dm [rows, K/64]: per superblock 4 K-granule rows =
    # [d_hi, dmin_hi, d_lo, dmin_lo] — an exact bf16 hi/lo split of the
    # f16 d/dmin (see _hi_lo)
    d_hi, d_lo = _hi_lo(d)
    mn_hi, mn_lo = _hi_lo(dmin)
    dm = np.empty((rows, nsb, 4), dtype=SCALE_DTYPE)
    dm[:, :, 0] = d_hi
    dm[:, :, 1] = mn_hi
    dm[:, :, 2] = d_lo
    dm[:, :, 3] = mn_lo
    # ggml Q4_K nibble order: qs chunk c (32B) holds sub-block 2c in lo
    # nibbles (elements 64c..64c+31) and sub-block 2c+1 in hi nibbles.
    qs = b[:, :, 16:144].reshape(rows, nsb, 4, 32)
    lo = qs & 0x0F
    hi = qs >> 4
    q = np.stack([lo, hi], axis=3).reshape(rows, cols).astype(np.int8) - 8
    # meta: ALL q4_k metadata in ONE int8 array [3K/32, N] — per superblock
    # 24 K-granule rows: 8 sc6, 8 mn6, 4 low bytes of the bf16 hi/lo
    # d/dmin quad, 4 high bytes (the kernel rebuilds bf16 via a 16-bit
    # bitcast). One metadata stream instead of three.
    dmu = np.ascontiguousarray(dm).view(np.uint16)  # [rows, nsb, 4] bf16 bits
    meta = np.concatenate(
        [
            sc6, mn6,
            (dmu & 0xFF).astype(np.int8),
            (dmu >> 8).astype(np.int8),
        ],
        axis=2,
    )  # [rows, nsb, 24]
    return {
        "qs": _pack_signed_pairs(_t(q)),
        "meta": _t(meta.reshape(rows, 3 * cols // 32)),
    }


def _pack_hi2_planes(hi2_t: np.ndarray) -> np.ndarray:
    """[K, N] values in 0..3 -> u8 [K/4, N], PLANE-MAJOR per 256-row
    K-granule (= one q6_k superblock): byte row j of granule g packs
    hi2[g*256 + i*64 + j] at bits 2i..2i+1. Extraction is then shift +
    mask per bit plane (ops/quant_matmul._planes_q6_k)."""
    Kk, Nn = hi2_t.shape
    g = hi2_t.reshape(Kk // 256, 4, 64, Nn)
    qh = (g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)).astype(np.uint8)
    return qh.reshape(Kk // 4, Nn)


def pack_q6_k(raw, shape) -> dict[str, np.ndarray]:
    # split-plane device format (6.75 bpw vs ggml wire 6.5625): the 6-bit
    # value q in [-32, 31] (u = q + 32) splits into
    #   ql  u8 [K/2, N]  K-paired signed nibbles of s4 = (u & 15) - 8
    #   qh  u8 [K/4, N]  plane-major 2-bit fields of hi2 = u >> 4
    #   sc8 i8 [K/16, N] ggml's EXACT per-16 sub-scales (unchanged)
    #   d   bf16 [K/64, N] exact hi/lo superscale pairs (unchanged)
    # Reconstruction q = s4 + 16*hi2 - 24 is exact integer math, so
    # dequant matches ggml (d rides as an exact bf16 hi/lo pair).
    rows, cols = shape
    nsb = cols // 256
    b = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, nsb, 210)
    ql = b[:, :, 0:128]
    qh = b[:, :, 128:192]
    sc8 = b[:, :, 192:208].view(np.int8).reshape(rows, nsb, 16)
    d = b[:, :, 208:210].copy().view("<f2").reshape(rows, nsb)
    # 4 rows per superblock = [d_hi, d_lo, d_hi, d_lo]: exact bf16 hi/lo
    # split of the f16 d (see _hi_lo)
    d_hi, d_lo = _hi_lo(d)
    d4 = np.empty((rows, nsb, 4), dtype=SCALE_DTYPE)
    d4[:, :, 0::2] = d_hi[:, :, None]
    d4[:, :, 1::2] = d_lo[:, :, None]
    d4 = d4.reshape(rows, cols // 64)
    # Decode ggml's interleaved (ql, qh) into plain 6-bit values u = q+32.
    q = np.empty((rows, nsb, 256), dtype=np.uint8)
    for n in range(2):
        lq = ql[:, :, n * 64 : n * 64 + 64]
        hq = qh[:, :, n * 32 : n * 32 + 32]
        base = n * 128
        q[:, :, base : base + 32] = (lq[:, :, :32] & 0x0F) | (((hq >> 0) & 3) << 4)
        q[:, :, base + 32 : base + 64] = (lq[:, :, 32:] & 0x0F) | (((hq >> 2) & 3) << 4)
        q[:, :, base + 64 : base + 96] = (lq[:, :, :32] >> 4) | (((hq >> 4) & 3) << 4)
        q[:, :, base + 96 : base + 128] = (lq[:, :, 32:] >> 4) | (((hq >> 6) & 3) << 4)
    u = _t(q.reshape(rows, cols))  # [K, N] values 0..63
    s4 = (u & 0x0F).astype(np.int8) - 8
    return {
        "ql": _pack_signed_pairs(s4),
        "qh": _pack_hi2_planes(u >> 4),
        "sc8": _t(sc8.reshape(rows, cols // 16)),
        "d": _t(d4),
    }


_PACKERS = {
    "q4_0": (GGMLType.Q4_0, pack_q4_0),
    "q8_0": (GGMLType.Q8_0, pack_q8_0),
    "q4_k": (GGMLType.Q4_K, pack_q4_k),
    "q6_k": (GGMLType.Q6_K, pack_q6_k),
}

GGML_TO_FMT = {
    GGMLType.Q4_0: "q4_0",
    GGMLType.Q8_0: "q8_0",
    GGMLType.Q4_K: "q4_k",
    GGMLType.Q6_K: "q6_k",
}


def from_ggml(raw, ggml_type: GGMLType, shape: tuple[int, int]) -> QTensor:
    """Convert a ggml-format payload into a device-layout QTensor (host side;
    arrays stay numpy until device_put). Uses the native (C++) parallel
    repacker when available; numpy otherwise (bit-identical layouts)."""
    fmt = GGML_TO_FMT[ggml_type]
    from .. import native

    arrays = native.repack(raw, ggml_type, shape)
    if arrays is None:
        arrays = _PACKERS[fmt][1](raw, shape)
    return QTensor(fmt, arrays)


def quantize_array(x: np.ndarray, fmt: str) -> QTensor:
    """Quantize a float [rows, cols] matrix directly into device layout."""
    ggml_type = _PACKERS[fmt][0]
    raw = numpy_ref.quantize(np.asarray(x, np.float32), ggml_type)
    return from_ggml(raw, ggml_type, tuple(x.shape))


# ---------------------------------------------------------------------------
# Device-side dequantization (the plain XLA path; the matmul kernel fuses
# the same arithmetic into its tiles)
# ---------------------------------------------------------------------------

def _unpack_signed_pairs(qs: jax.Array) -> jax.Array:
    """u8 [K/2, N] nibble pairs -> int32 [K, N] signed values."""
    lo = (qs & 0x0F).astype(jnp.int32)
    hi = (qs >> 4).astype(jnp.int32)
    lo = lo - 16 * (lo >= 8)
    hi = hi - 16 * (hi >= 8)
    Kh, N = qs.shape
    return jnp.stack([lo, hi], axis=1).reshape(2 * Kh, N)


def dequant_t(qt: QTensor, dtype=jnp.bfloat16) -> jax.Array:
    """Dequantize to the K-major [K, N] matrix (y = x @ dequant_t(w))."""
    N, K = qt.shape
    a = qt.arrays
    if qt.fmt == "q8_0":
        q = a["qs"].astype(jnp.float32).reshape(K // 32, 32, N)
        sc = a["scales"].astype(jnp.float32)
        x = (q * sc[:, None, :]).reshape(K, N)
    elif qt.fmt == "q4_0":
        q = _unpack_signed_pairs(a["qs"]).astype(jnp.float32)
        sc = a["scales"].astype(jnp.float32)  # bf16 [K/32, N] widened
        x = (q.reshape(K // 32, 32, N) * sc[:, None, :]).reshape(K, N)
    elif qt.fmt == "q4_k":
        # w = sc*(q-8) + (8*sc - mn), sc = d*sc6, mn = dmin*mn6 — f32 math
        # from exact int sub-scales and the exact bf16 hi/lo d/dmin pair
        # (rebuilt from its lo/hi byte rows): bit-identical to ggml
        q = _unpack_signed_pairs(a["qs"]).astype(jnp.float32)
        S = K // 256
        mv = a["meta"].reshape(S, 24, N)
        scm = mv[:, 0:16, :].astype(jnp.float32)
        lo = mv[:, 16:20, :].astype(jnp.int32) & 0xFF
        hi = mv[:, 20:24, :].astype(jnp.int32) & 0xFF
        dm16 = ((hi << 8) | lo).astype(jnp.uint16)
        dmf = jax.lax.bitcast_convert_type(dm16, jnp.bfloat16).astype(jnp.float32)
        d, dmin = dmf[:, 0, :] + dmf[:, 2, :], dmf[:, 1, :] + dmf[:, 3, :]
        sc = scm[:, 0:8, :] * d[:, None, :]
        mn = scm[:, 8:16, :] * dmin[:, None, :]
        sc = sc.reshape(K // 32, N)
        offs = (8.0 * sc - mn.reshape(K // 32, N))
        x = (
            q.reshape(K // 32, 32, N) * sc[:, None, :] + offs[:, None, :]
        ).reshape(K, N)
    elif qt.fmt == "q6_k":
        # split-plane: q = s4 + 16*hi2 - 24, exact integers
        s4 = _unpack_signed_pairs(a["ql"])
        g = a["qh"].astype(jnp.int32).reshape(K // 256, 64, N)
        hi2 = jnp.concatenate(
            [(g >> 0) & 3, (g >> 2) & 3, (g >> 4) & 3, g >> 6], axis=1
        ).reshape(K, N)
        q = (s4 + 16 * hi2 - 24).astype(jnp.float32)
        S = K // 256
        dv = a["d"].astype(jnp.float32).reshape(S, 4, N)
        d = dv[:, 0, :] + dv[:, 1, :]  # exact bf16 hi/lo pair
        sc = (a["sc8"].astype(jnp.float32).reshape(S, 16, N) * d[:, None, :])
        sc = sc.reshape(K // 16, N)
        x = (q.reshape(K // 16, 16, N) * sc[:, None, :]).reshape(K, N)
    else:
        raise NotImplementedError(qt.fmt)
    return x.astype(dtype)


def dequant(qt: QTensor, dtype=jnp.bfloat16) -> jax.Array:
    """Dequantize to the logical [N, K] matrix (tests / golden reference)."""
    return dequant_t(qt, dtype).T


def concat_rows(qts: list["QTensor"]) -> "QTensor":
    """Concatenate QTensors along the logical row (out-feature / N) axis.

    Used to fuse per-layer projections (q|k|v, gate|up) into one matmul —
    fewer kernel launches and bigger tiles. All inputs must share fmt and K.
    Device arrays are [K-granule, N], so this is an axis-1 concat."""
    fmt = qts[0].fmt
    K = qts[0].shape[1]
    if any(q.fmt != fmt or q.shape[1] != K for q in qts):
        raise ValueError("concat_rows requires matching fmt and in-features")
    xp = jnp if any(isinstance(a, jax.Array) for a in qts[0].arrays.values()) else np
    arrays = {
        k: xp.concatenate([q.arrays[k] for q in qts], axis=1) for k in qts[0].arrays
    }
    return QTensor(fmt, arrays)


def pad_rows(qt: QTensor, n_new: int) -> QTensor:
    """Zero-pad the logical row (out-feature / N) axis to `n_new` rows.

    Used to pad the vocab dim of the embedding/head to a 2048 multiple, so
    the lm_head matmul splits into whole column slabs (the raw Gemma vocab
    256128 is 2^7 * 2001). Zero scales dequantize to exact zero rows;
    callers slice the logits back to the true vocab."""
    N, K = qt.shape
    if n_new == N:
        return qt
    if n_new < N:
        raise ValueError(f"pad_rows: {n_new} < current rows {N}")
    xp = jnp if any(isinstance(a, jax.Array) for a in qt.arrays.values()) else np
    arrays = {
        k: xp.pad(a, ((0, 0), (0, n_new - N))) for k, a in qt.arrays.items()
    }
    return QTensor(qt.fmt, arrays)


def gather_dequant(qt: QTensor, indices: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """Gather logical rows (out-features / vocab entries) `indices` of a
    quantized [N, K] matrix and dequantize only those rows -> [..., K].

    Embedding lookup without materializing the table; rows are the last
    (N) axis of the device arrays."""
    flat = indices.reshape(-1)
    arrays = {k: jnp.take(a, flat, axis=1) for k, a in qt.arrays.items()}
    sub = QTensor(qt.fmt, arrays)
    return dequant(sub, dtype).reshape(*indices.shape, qt.shape[1])
