"""Golden-tensor dump / differential-testing harness.

Re-creation of the reference's dominant test mechanism (SURVEY.md §4):
`tensor_dump.cpp` writes raw tensor bytes per run labeled `source` (the
engine under test) or `target` (the trusted reference, there llama.cpp) and
byte-compares them, driven by a dump-list config file. Differences here:

* dumps are ``.npy`` (dtype+shape preserved) instead of raw bytes;
* comparison is tolerance-aware (`atol`/`rtol` + max/mean error report) —
  byte-exactness is only achievable for identical arithmetic, which bf16
  on the accelerator deliberately is not (SURVEY.md §4 implication);
* the capture hook is first-class: `capture()` opens a context that
  `gemma.forward` (and anything else) reports named activations into,
  filtered by the same `name:tensor` dump-list format the reference uses
  (`tensor_dump/dump_tensor_list`, parser at tensor_dump.cpp:95-117).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading
from pathlib import Path

import numpy as np

_local = threading.local()


def _to_numpy(value) -> np.ndarray:
    """numpy-ify, widening non-native dtypes (bf16, fp8) to float32 —
    np.save round-trips ml_dtypes arrays as opaque void otherwise."""
    arr = np.asarray(value)
    if arr.dtype.kind == "V" or arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        arr = np.asarray(value, dtype=np.float32)
    return arr


# ---------------------------------------------------------------------------
# Capture context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Capture:
    patterns: tuple[str, ...]
    values: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def wants(self, name: str) -> bool:
        return any(fnmatch.fnmatch(name, p) for p in self.patterns)

    def record(self, name: str, value) -> None:
        if self.wants(name):
            import jax

            if isinstance(value, jax.core.Tracer):
                raise RuntimeError(
                    f"capture of {name!r} under jit: run the forward un-jitted "
                    "when capturing activations"
                )
            self.values[name] = _to_numpy(value)


@contextlib.contextmanager
def capture(patterns: list[str] | tuple[str, ...] = ("*",)):
    """Collect named activations emitted via `record` inside this context.

    NOTE: capturing forces eager materialization of the captured tensors;
    run the model un-jitted (or re-jitted per capture) when capturing.
    """
    cap = Capture(tuple(patterns))
    prev = getattr(_local, "capture", None)
    _local.capture = cap
    try:
        yield cap
    finally:
        _local.capture = prev
        if not cap.values:
            import warnings

            warnings.warn(
                "tensor_dump.capture recorded nothing — already-compiled "
                "jitted code does not re-trace; use Engine.capture_activations "
                "(un-jitted forward)",
                stacklevel=2,
            )


def record(name: str, value) -> None:
    """Report a named activation to the active capture context (no-op when
    none is active — safe to leave in hot paths; under jit with no capture
    active this traces to nothing)."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.record(name, value)


def capturing() -> bool:
    return getattr(_local, "capture", None) is not None


# ---------------------------------------------------------------------------
# Dump / compare (reference: dump_tensor / compare_tensors)
# ---------------------------------------------------------------------------

def dump_tensor(name: str, value, directory: str | Path, mode: str = "source") -> Path:
    """Write `<dir>/<name>_<mode>.npy` (reference naming: tensor_dump.h:15-17)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{_sanitize(name)}_{mode}.npy"
    np.save(path, _to_numpy(value))
    return path


def load_tensor(name: str, directory: str | Path, mode: str = "target") -> np.ndarray:
    return np.load(Path(directory) / f"{_sanitize(name)}_{mode}.npy")


def _sanitize(name: str) -> str:
    return name.replace("/", "_").replace(":", "_")


@dataclasses.dataclass
class DiffResult:
    name: str
    ok: bool
    max_abs: float
    max_rel: float
    mean_abs: float
    first_mismatch: tuple | None
    shape_mismatch: bool = False

    def __str__(self) -> str:
        if self.shape_mismatch:
            return f"[{self.name}] SHAPE MISMATCH"
        s = "OK " if self.ok else "FAIL"
        loc = f" first@{self.first_mismatch}" if self.first_mismatch else ""
        return (
            f"[{self.name}] {s} max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e} mean_abs={self.mean_abs:.3e}{loc}"
        )


def compare_tensors(
    name: str,
    source: np.ndarray,
    target: np.ndarray,
    atol: float = 1e-3,
    rtol: float = 1e-2,
) -> DiffResult:
    """Tolerance-aware diff with first-mismatch reporting (the reference's
    compare_tensors, tensor_dump.cpp:33-89, generalized from byte-exact)."""
    source = np.asarray(source, np.float32)
    target = np.asarray(target, np.float32)
    if source.shape != target.shape:
        return DiffResult(name, False, np.inf, np.inf, np.inf, None, shape_mismatch=True)
    diff = np.abs(source - target)
    denom = np.abs(target) + 1e-12
    ok_mask = diff <= atol + rtol * np.abs(target)
    ok = bool(ok_mask.all())
    first = None
    if not ok:
        first = tuple(int(i) for i in np.argwhere(~ok_mask)[0])
    return DiffResult(
        name,
        ok,
        float(diff.max(initial=0.0)),
        float((diff / denom).max(initial=0.0)),
        float(diff.mean()) if diff.size else 0.0,
        first,
    )


def compare_with_golden(
    values: dict[str, np.ndarray],
    directory: str | Path,
    atol: float = 1e-3,
    rtol: float = 1e-2,
) -> list[DiffResult]:
    """Diff captured activations against `<dir>/<name>_target.npy` dumps."""
    return [
        compare_tensors(n, v, load_tensor(n, directory, "target"), atol, rtol)
        for n, v in sorted(values.items())
    ]


# ---------------------------------------------------------------------------
# Dump-list config (reference format: "name:tensor_name", // comments)
# ---------------------------------------------------------------------------

def parse_dump_list(path: str | Path) -> list[tuple[str, str]]:
    """Parse the reference's dump-list format (tensor_dump.cpp:95-117):
    one `label:tensor_name` per line; `//` starts a comment."""
    out: list[tuple[str, str]] = []
    for raw in Path(path).read_text().splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        label, _, tensor = line.partition(":")
        if not tensor:
            raise ValueError(f"bad dump-list line: {raw!r}")
        out.append((label.strip(), tensor.strip()))
    return out
