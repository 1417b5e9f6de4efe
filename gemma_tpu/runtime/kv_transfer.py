"""Cross-process prefill→decode KV handoff (disaggregated serving).

Config 5's prefill/decode disaggregation across *hosts* needs the prefill
output — the `Engine.prefill_standalone` insert tuple — to cross a process
boundary. This module supplies the mechanism (without it `serve()` on a
pure-prefill host would be a no-op):

* `serialize_prefill` / `deserialize_prefill`: byte-exact host-side
  encoding of the insert tuple (logits, K/V sequence, int8 scales, length).
  bf16 arrays ride as uint16 bit patterns, so the round trip is
  bit-for-bit regardless of the receiver's ml_dtypes registration.
* `prefill_server(engine, sock)`: the prefill host's loop — receive
  prompt requests, run `prefill_standalone`, stream framed tuples back.
* `RemotePrefillClient`: duck-types the prefill-engine surface the
  `Scheduler` drives (`ecfg`, `prefill_standalone`), so a decode host
  passes it as `prefill_engine=` and the existing admission path works
  unchanged — the KV chunk is fetched over the wire instead of computed.

Transport is a stream socket (TCP or AF_UNIX). Within a host the same
framing could ride device-to-device transfers; the socket path is the
portable mechanism and the serialization boundary is identical.

The reference has no counterpart (strictly single-process,
/root/reference/src/app.cpp:16-45); the mandate is SURVEY.md §2's
distributed-serving checklist.
"""
from __future__ import annotations

import io
import json
import socket
import struct
from typing import Any

import numpy as np

import ml_dtypes

_BF16 = np.dtype(ml_dtypes.bfloat16)


# ---------------------------------------------------------------------------
# Byte-exact tuple serialization
# ---------------------------------------------------------------------------

def serialize_prefill(pre) -> bytes:
    """Insert tuple -> bytes. Arrays are pulled to host (numpy); bf16 is
    stored as its uint16 bit pattern (np.savez cannot round-trip ml_dtypes
    without pickling), so deserialize() is bit-for-bit."""
    logits, k_seq, v_seq, (k_sc, v_sc), length = pre
    arrays: dict[str, np.ndarray] = {
        "logits": np.asarray(logits),
        "k_seq": np.asarray(k_seq),
        "v_seq": np.asarray(v_seq),
        "length": np.asarray(length, np.int64),
    }
    if k_sc is not None:
        arrays["k_scale"] = np.asarray(k_sc)
        arrays["v_scale"] = np.asarray(v_sc)
    out: dict[str, np.ndarray] = {}
    for name, a in arrays.items():
        if a.dtype == _BF16:
            out[name + "__bf16"] = a.view(np.uint16)
        else:
            out[name] = a
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def deserialize_prefill(data: bytes):
    z = np.load(io.BytesIO(data))
    arrays: dict[str, np.ndarray] = {}
    for name in z.files:
        a = z[name]
        if name.endswith("__bf16"):
            arrays[name[: -len("__bf16")]] = a.view(_BF16)
        else:
            arrays[name] = a
    k_sc = arrays.get("k_scale")
    v_sc = arrays.get("v_scale")
    return (
        arrays["logits"], arrays["k_seq"], arrays["v_seq"],
        (k_sc, v_sc), int(arrays["length"]),
    )


# ---------------------------------------------------------------------------
# Framing (length-prefixed) over a stream socket
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n > 0:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> bytes | None:
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (n,) = struct.unpack("<Q", header)
    return _recv_exact(sock, n)


# ---------------------------------------------------------------------------
# Prefill host: server loop
# ---------------------------------------------------------------------------

def engine_handshake(engine) -> dict[str, Any]:
    """The decode side needs the prefill engine's KV format to validate the
    handoff (Scheduler's format check) and its bucketing to size page
    allocations (_prefill_T)."""
    import jax.numpy as jnp

    e = engine.ecfg
    return {
        "kv_quantized": bool(e.kv_quantized),
        "kv_dtype": str(jnp.dtype(e.kv_dtype)),
        "prefill_bucket_min": int(e.prefill_bucket_min),
        # chunked/overlapped admission needs the engine in-process; remote
        # prefills always arrive whole
        "prefill_chunk": 0,
        "paged": bool(e.paged),
        "page_size": int(e.page_size),
        "max_seq_len": int(e.max_seq_len),
    }


def prefill_server(engine, sock: socket.socket, max_requests: int | None = None) -> int:
    """Serve prefill requests on an accepted connection until the peer
    disconnects (or `max_requests`). Returns the number served.

    Protocol: handshake frame (JSON) out; then per request a JSON frame
    {"prompt": [...], "pad_to": int|null} in, one serialized tuple out."""
    _send_frame(sock, json.dumps(engine_handshake(engine)).encode())
    served = 0
    while max_requests is None or served < max_requests:
        frame = _recv_frame(sock)
        if frame is None:
            break
        req = json.loads(frame.decode())
        pre = engine.prefill_standalone(
            [int(t) for t in req["prompt"]], pad_to=req.get("pad_to") or None
        )
        _send_frame(sock, serialize_prefill(pre))
        served += 1
    return served


def serve_prefill_host(engine, address: tuple[str, int] | str,
                       max_connections: int = 1) -> None:
    """Bind + listen at `address` ((host, port) TCP or a string AF_UNIX
    path) and serve prefill connections; returns after `max_connections`
    peers disconnect."""
    fam = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    with socket.socket(fam, socket.SOCK_STREAM) as srv:
        if fam == socket.AF_INET:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(address)
        srv.listen(max_connections)
        for _ in range(max_connections):
            conn, _addr = srv.accept()
            with conn:
                prefill_server(engine, conn)


# ---------------------------------------------------------------------------
# Decode host: remote prefill client (Scheduler's prefill_engine surface)
# ---------------------------------------------------------------------------

class RemotePrefillClient:
    """Duck-types the prefill-engine surface `runtime.Scheduler` drives:
    `.ecfg` (KV-format check + admission bucketing) and
    `.prefill_standalone(prompt, pad_to)`. Each call is one request frame
    out, one deserialized insert tuple in — the KV chunk crosses the
    process boundary byte-for-byte."""

    def __init__(self, address: tuple[str, int] | str | socket.socket):
        from .engine import EngineConfig

        if isinstance(address, socket.socket):
            self._sock = address
        else:
            fam = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
            self._sock = socket.socket(fam, socket.SOCK_STREAM)
            self._sock.connect(address)
        hs = json.loads(_recv_frame(self._sock).decode())
        import jax.numpy as jnp

        self.handshake = hs
        self.ecfg = EngineConfig(
            max_seq_len=hs["max_seq_len"],
            kv_quantized=hs["kv_quantized"],
            kv_dtype=jnp.dtype(hs["kv_dtype"]),
            prefill_bucket_min=hs["prefill_bucket_min"],
            prefill_chunk=hs["prefill_chunk"],
            paged=hs["paged"],
            page_size=hs["page_size"],
        )

    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        _send_frame(
            self._sock,
            json.dumps({"prompt": list(prompt), "pad_to": pad_to}).encode(),
        )
        frame = _recv_frame(self._sock)
        if frame is None:
            raise ConnectionError("prefill host disconnected")
        return deserialize_prefill(frame)

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# Worker entry point (spawned as a real separate process in tests)
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> None:
    """python -m gemma_tpu.runtime.kv_transfer --gguf m.gguf --port 0
    Builds an Engine from the checkpoint and serves prefill requests.
    Prints "PORT <n>" once listening (for the parent to connect).

    The worker is a process of its own. JAX reserves three quarters of a
    card's memory when a process first uses it, so a worker on a card that
    another JAX process already holds needs its own share
    (XLA_PYTHON_CLIENT_MEM_FRACTION) or its own card
    (CUDA_VISIBLE_DEVICES)."""
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--gguf", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--kv-quantized", action="store_true")
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--max-connections", type=int, default=1)
    args = ap.parse_args(argv)

    from ..gguf import GGUFReader
    from ..models import load_params
    from .engine import Engine, EngineConfig

    cfg, params = load_params(GGUFReader(args.gguf), mode="dequant")
    engine = Engine(
        cfg, params,
        EngineConfig(max_seq_len=args.max_seq_len, kv_quantized=args.kv_quantized),
    )
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", args.port))
        srv.listen(args.max_connections)
        print(f"PORT {srv.getsockname()[1]}", flush=True)
        for _ in range(args.max_connections):
            conn, _addr = srv.accept()
            with conn:
                n = prefill_server(engine, conn)
                print(f"SERVED {n}", flush=True)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
