"""Where the hand-written Pallas kernels run: the one backend check.

On the GPU the kernels are compiled through Pallas's Triton route; a kernel
that fails to compile raises, it never falls back. On the CPU they run only
in Pallas interpret mode, and only inside :func:`interpret_kernels`, the
test hook a fixture enters and leaves. Anywhere else the plain XLA path
runs. :func:`plain_path` routes calls through that plain path, so the
kernels can be diffed (utils.verify) and timed (bench.py) against it on
the card.
"""
from __future__ import annotations

import contextlib

import jax

_interpret_hook = False
_plain_ops: frozenset[str] = frozenset()
OPS = ("matmul", "attention")


@contextlib.contextmanager
def interpret_kernels():
    """Test hook: run the kernels in interpret mode on the CPU backend."""
    global _interpret_hook
    if jax.default_backend() != "cpu":
        raise RuntimeError("interpret mode is a CPU test hook only")
    prev, _interpret_hook = _interpret_hook, True
    try:
        yield
    finally:
        _interpret_hook = prev


@contextlib.contextmanager
def plain_path(*ops: str):
    """Route `ops` (of OPS; all of them by default) through the plain XLA
    path. Read at trace time, so it applies to what is traced inside."""
    global _plain_ops
    if not set(ops) <= set(OPS):
        raise ValueError(f"unknown ops {ops}; expected some of {OPS}")
    prev = _plain_ops
    _plain_ops = prev | frozenset(ops or OPS)
    try:
        yield
    finally:
        _plain_ops = prev


def interpret() -> bool:
    """The `interpret` argument every pallas_call of this package gets."""
    return _interpret_hook and jax.default_backend() == "cpu"


def use_kernels(op: str) -> bool:
    """True where the kernels of `op` ("matmul" or "attention") run:
    compiled on a GPU, interpreted on the CPU under the test hook. Read at
    trace time."""
    if op in _plain_ops:
        return False
    return jax.default_backend() == "gpu" or interpret()


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"
