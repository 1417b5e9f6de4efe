"""GGUF reader: mmap-backed, zero-copy parser for GGUF v2/v3 files.

Native replacement for the ggml `gguf_init_from_file` / `gguf_get_*` API the
reference relies on (`/root/reference/src/gemma_model.cpp:24-157,596-648`).
Unlike the reference — which eagerly materializes every tensor into a ggml
context (`no_alloc=false`) — tensor payloads here stay memory-mapped and are
only touched when a consumer asks for them, so multi-gigabyte checkpoints can
be streamed shard-by-shard straight to device memory.
"""
from __future__ import annotations

import dataclasses
import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO, Iterator

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
    row_size,
)

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype("<u1"),
    GGUFValueType.INT8: np.dtype("<i1"),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype("?"),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}

_GGML_NP: dict[GGMLType, np.dtype] = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.I8: np.dtype("<i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
    # BF16 surfaces as raw uint16; callers reinterpret.
    GGMLType.BF16: np.dtype("<u2"),
}


class _Cursor:
    """Sequential binary reader over a buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError(f"GGUF truncated: wanted {n} bytes at {self.pos}")
        self.pos += n
        return bytes(out)

    def scalar(self, vt: GGUFValueType):
        fmt = _SCALAR_FMT[vt]
        (v,) = struct.unpack(fmt, self.read(struct.calcsize(fmt)))
        return v

    def u32(self) -> int:
        return self.scalar(GGUFValueType.UINT32)

    def u64(self) -> int:
        return self.scalar(GGUFValueType.UINT64)

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def string(self) -> str:
        n = self.u64()
        if n > self.remaining():
            raise EOFError(
                f"GGUF truncated: string of {n} bytes at {self.pos} exceeds "
                f"the {self.remaining()} bytes left"
            )
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vt: GGUFValueType):
        if vt == GGUFValueType.STRING:
            return self.string()
        if vt == GGUFValueType.ARRAY:
            elem_t = GGUFValueType(self.u32())
            count = self.u64()
            # an absurd count must fail fast, not hang a 2^60-iteration
            # loop: every element consumes >= 1 byte (strings >= 8)
            min_elem = 8 if elem_t in (GGUFValueType.STRING, GGUFValueType.ARRAY) else 1
            if count * min_elem > self.remaining():
                raise EOFError(
                    f"GGUF truncated: array of {count} x {elem_t.name} at "
                    f"{self.pos} exceeds the {self.remaining()} bytes left"
                )
            if elem_t == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            if elem_t == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = _SCALAR_NP[elem_t]
            raw = self.read(count * dt.itemsize)
            return np.frombuffer(raw, dtype=dt, count=count)
        return self.scalar(vt)


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """One tensor entry of the GGUF tensor directory.

    ``shape`` is in logical (row-major, numpy) order — i.e. the *reverse* of
    the GGUF on-disk ``ne`` order, where ne[0] is the contiguous dimension.
    """

    name: str
    shape: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # relative to the start of the data section
    n_bytes: int

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class GGUFReader:
    """Parses a GGUF file; exposes metadata KVs and lazily-mapped tensors."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._mm)

        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: bad GGUF magic {magic:#x}")
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.u64()
        n_kv = cur.u64()
        # each KV / tensor entry consumes >= 12 bytes; absurd counts (a
        # corrupt or adversarial header) must fail fast, not loop for hours
        if (n_tensors + n_kv) * 12 > len(self._mm):
            raise ValueError(
                f"{path}: header claims {n_tensors} tensors + {n_kv} KVs "
                f"but the file is only {len(self._mm)} bytes"
            )

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.string()
            try:
                vt = GGUFValueType(cur.u32())
            except ValueError as e:
                raise ValueError(f"{path}: KV '{key}': {e}") from None
            self.metadata[key] = cur.value(vt)

        self.alignment = int(self.metadata.get(Keys.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        if self.alignment <= 0 or self.alignment & (self.alignment - 1):
            raise ValueError(
                f"{path}: general.alignment must be a positive power of two, "
                f"got {self.alignment}"
            )

        self.tensors: dict[str, TensorInfo] = {}
        order: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.u32()
            if n_dims > 4:  # GGML_MAX_DIMS
                raise ValueError(f"{path}: tensor '{name}' has {n_dims} dims (max 4)")
            ne = [cur.u64() for _ in range(n_dims)]
            if any(d < 0 or d > 1 << 40 for d in ne):
                raise ValueError(f"{path}: tensor '{name}' has absurd dims {ne}")
            try:
                ggml_type = GGMLType(cur.u32())
            except ValueError as e:
                raise ValueError(f"{path}: tensor '{name}': {e}") from None
            offset = cur.u64()
            shape = tuple(reversed(ne))
            n_rows = int(np.prod(ne[1:])) if len(ne) > 1 else 1
            try:
                nbytes = n_rows * row_size(ggml_type, int(ne[0]) if ne else 1)
            except ValueError as e:
                raise ValueError(f"{path}: tensor '{name}': {e}") from None
            if name in self.tensors:
                raise ValueError(f"{path}: duplicate tensor name '{name}'")
            ti = TensorInfo(name, shape, ggml_type, offset, nbytes)
            self.tensors[name] = ti
            order.append(ti)
        self.tensor_order = order

        pad = -cur.pos % self.alignment
        self.data_offset = cur.pos + pad
        data_size = len(self._mm) - self.data_offset
        for ti in order:
            if ti.offset % self.alignment:
                raise ValueError(
                    f"{path}: tensor '{ti.name}' offset {ti.offset} is not "
                    f"{self.alignment}-aligned"
                )
            if ti.offset + ti.n_bytes > data_size:
                raise ValueError(
                    f"{path}: tensor '{ti.name}' payload [{ti.offset}, "
                    f"{ti.offset + ti.n_bytes}) exceeds the {data_size}-byte "
                    "data section (truncated file?)"
                )

    # -- metadata access ---------------------------------------------------
    @property
    def architecture(self) -> str:
        return self.metadata.get(Keys.ARCHITECTURE, "unknown")

    def kv(self, key: str, default=None, *, arch: str | None = None):
        """Typed KV lookup; `{arch}` in the key is substituted."""
        if "{arch}" in key:
            key = key.format(arch=arch or self.architecture)
        return self.metadata.get(key, default)

    # -- tensor access -----------------------------------------------------
    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw bytes of the tensor payload as a zero-copy uint8 view."""
        ti = self.tensors[name]
        start = self.data_offset + ti.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.n_bytes, offset=start)

    def tensor_array(self, name: str) -> np.ndarray:
        """Tensor as a numpy array for non-quantized types (zero-copy view)."""
        ti = self.tensors[name]
        dt = _GGML_NP.get(ti.ggml_type)
        if dt is None:
            raise TypeError(
                f"{name} is block-quantized {ti.ggml_type.name}; use tensor_raw() "
                "+ gemma_tpu.quant to decode"
            )
        return self.tensor_raw(name).view(dt).reshape(ti.shape)

    def __iter__(self) -> Iterator[TensorInfo]:
        return iter(self.tensor_order)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
