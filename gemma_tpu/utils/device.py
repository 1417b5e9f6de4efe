"""Peak rates of the accelerators the roofline numbers are divided by.

One table, keyed by the `device_kind` JAX reports, shared by bench.py, the
profiler and the CLI (the reference has no equivalent — its only hardware
knowledge is the pinned OpenCL device name, `/root/reference/src/macro.h:25-26`).
A device that is not in the table is an error, not a default.

Source: NVIDIA H100 Tensor Core GPU data sheet — dense rates, without
sparsity, at the part's full power limit.
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    hbm_gbs: float  # device memory bandwidth, GB/s
    bf16_flops: float  # dense bf16 tensor-core rate, FLOP/s


PEAKS: dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(3350.0, 989e12),  # H100 SXM5
    "NVIDIA H100 PCIe": Peaks(2000.0, 756e12),
}


class UnknownDevice(LookupError):
    pass


def peaks_for(kind: str) -> Peaks:
    try:
        return PEAKS[kind]
    except KeyError:
        raise UnknownDevice(
            f"no peak rates for device kind {kind!r}; add it to "
            f"gemma_tpu.utils.device.PEAKS with its source"
        ) from None


def device_peaks() -> Peaks:
    """Peaks of the first visible device; raises UnknownDevice if absent."""
    import jax

    return peaks_for(jax.devices()[0].device_kind)
