"""Profiling: named spans, counters, and a per-kernel roofline tracer.

Counterpart of the reference's interval profiler
(`/root/reference/src/profiling.cpp:15-135`): same capabilities — named
accumulating spans with call counts, named counters, prefix-grouped
percentage report — plus what the reference cannot do: a roofline ledger
that records bytes-moved and FLOPs per kernel invocation and reports
achieved vs peak bandwidth/compute (the BASELINE.json "per-kernel roofline
tracer" mandate). `jax.profiler` traces can be captured around any span for
XLA-level drill-down.

Usage::

    from gemma_tpu.utils import profiling as prof
    prof.enable()
    with prof.span("decode.step"):
        ...
    prof.add_count("tokens", 128)
    prof.roofline("q4_0_matmul", seconds=t, bytes_moved=nb, flops=fl)
    print(prof.report())

Spans measure host wall-clock (device work must be block_until_ready'd by
the caller — jitted steps are async). Disabled (the default) everything is
a no-op, mirroring the reference's compile-time gate (profiling.h:8).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class _SpanStat:
    total_s: float = 0.0
    excl_s: float = 0.0  # total minus time spent in nested spans
    count: int = 0


@dataclass
class _RooflineStat:
    total_s: float = 0.0
    bytes_moved: int = 0
    flops: int = 0
    count: int = 0


@dataclass
class _State:
    enabled: bool = False
    spans: dict[str, _SpanStat] = field(default_factory=lambda: collections.defaultdict(_SpanStat))
    counters: dict[str, float] = field(default_factory=lambda: collections.defaultdict(float))
    rooflines: dict[str, _RooflineStat] = field(default_factory=lambda: collections.defaultdict(_RooflineStat))
    lock: threading.Lock = field(default_factory=threading.Lock)
    # peaks for the roofline report (set_peaks / autoset_peaks); None on a
    # device without a row in utils.device.PEAKS: no share is printed then
    peak_hbm_gbs: float | None = None
    peak_flops: float | None = None
    # sampled-synchronous mode: the engine block_until_ready's every Nth
    # dispatched decode program, so span groups measure true device time
    # (async dispatch otherwise makes spans measure queueing only).
    # 0 = off.
    sync_every: int = 0


_state = _State()
_tls = threading.local()


def enable(sync_every: int | None = None) -> None:
    _state.enabled = True
    if sync_every is not None:
        _state.sync_every = sync_every


def set_sync_every(n: int) -> None:
    _state.sync_every = n


def sync_every() -> int:
    """Engine hook: block_until_ready every Nth decode dispatch (0 = never).
    Only meaningful while profiling is enabled."""
    return _state.sync_every if _state.enabled else 0


def disable() -> None:
    _state.enabled = False


def is_enabled() -> bool:
    return _state.enabled


def autoset_peaks() -> None:
    """Set roofline peaks from the visible accelerator's row of the peak
    table; a device without one (the CPU) gets no roofline share."""
    from .device import UnknownDevice, device_peaks

    try:
        hbm, flops = device_peaks()
    except UnknownDevice:
        _state.peak_hbm_gbs = _state.peak_flops = None
        return
    set_peaks(hbm_gbs=hbm, flops=flops)


def reset() -> None:
    with _state.lock:
        _state.spans.clear()
        _state.counters.clear()
        _state.rooflines.clear()


def set_peaks(hbm_gbs: float | None, flops: float | None) -> None:
    """Roofline peaks (GB/s, FLOP/s); None prints no share."""
    _state.peak_hbm_gbs = hbm_gbs
    _state.peak_flops = flops


@contextlib.contextmanager
def span(name: str):
    """Accumulating named interval (reference: _start/_stop_recording).

    Nested spans are overlap-accounted like the reference's concurrently-
    open-interval tracking (profiling.cpp:30-39): each span also records
    EXCLUSIVE time (total minus nested spans on the same thread), so group
    sums in the report reconcile with wall-clock instead of double-counting
    parents and children."""
    if not _state.enabled:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(0.0)  # nested-child time accumulator for this span
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        child = stack.pop()
        if stack:
            stack[-1] += dt
        with _state.lock:
            st = _state.spans[name]
            st.total_s += dt
            st.excl_s += dt - child
            st.count += 1


def add_count(name: str, value: float = 1.0) -> None:
    """Named counter channel (reference: _add_count, hpc.cpp:236-243)."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.counters[name] += value


def roofline(name: str, seconds: float, bytes_moved: int, flops: int = 0) -> None:
    """Record one kernel execution against the roofline ledger."""
    if not _state.enabled:
        return
    with _state.lock:
        st = _state.rooflines[name]
        st.total_s += seconds
        st.bytes_moved += bytes_moved
        st.flops += flops
        st.count += 1


def report(group_depth: int = 1) -> str:
    """Prefix-grouped report with % of total — the reference's
    print_profiling_result format (profiling.cpp:97-135), plus the roofline
    table."""
    lines: list[str] = []
    with _state.lock:
        # exclusive sums reconcile with wall-clock (no parent/child double
        # counting); per-span lines show both inclusive and exclusive
        total = sum(s.excl_s for s in _state.spans.values())
        if _state.spans:
            lines.append(f"== spans (exclusive total {total*1e3:.1f} ms) ==")
            groups: dict[str, list[tuple[str, _SpanStat]]] = collections.defaultdict(list)
            for name, st in _state.spans.items():
                prefix = ".".join(name.split(".")[:group_depth])
                groups[prefix].append((name, st))
            for prefix in sorted(groups, key=lambda p: -sum(s.excl_s for _, s in groups[p])):
                gtotal = sum(s.excl_s for _, s in groups[prefix])
                pct = 100.0 * gtotal / total if total else 0.0
                lines.append(f"[{prefix}] {gtotal*1e3:10.2f} ms  {pct:6.2f} %")
                for name, st in sorted(groups[prefix], key=lambda kv: -kv[1].excl_s):
                    lines.append(
                        f"  {name:<40} {st.excl_s*1e3:10.2f} ms excl "
                        f"({st.total_s*1e3:.2f} incl)  x{st.count:<6d}"
                        f" {st.total_s/st.count*1e6:9.1f} us/call"
                    )
        if _state.counters:
            lines.append("== counters ==")
            for name, v in sorted(_state.counters.items()):
                lines.append(f"  {name:<40} {v:g}")
        if _state.rooflines:
            lines.append("== roofline (achieved vs peak) ==")
            hbm, peak = _state.peak_hbm_gbs, _state.peak_flops
            for name, st in sorted(_state.rooflines.items(), key=lambda kv: -kv[1].total_s):
                bw = st.bytes_moved / st.total_s / 1e9 if st.total_s else 0.0
                fl = st.flops / st.total_s / 1e12 if st.total_s else 0.0
                line = (
                    f"  {name:<32} x{st.count:<6d} {st.total_s*1e3:9.2f} ms "
                    f"{bw:8.1f} GB/s {fl:7.2f} TFLOP/s"
                )
                if hbm and peak:
                    bw_pct = 100.0 * bw / hbm
                    fl_pct = 100.0 * fl * 1e12 / peak
                    bound = "BW" if bw_pct >= fl_pct else "FLOP"
                    line += (f" ({bw_pct:5.1f}% / {fl_pct:5.1f}% of peak)"
                             f" [{bound}-bound]")
                lines.append(line)
    return "\n".join(lines) if lines else "(profiling: no data)"


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a jax.profiler device trace around a region."""
    import jax

    with jax.profiler.trace(logdir):
        yield
