"""Multi-host serving: DCN data axis, cross-host batching, role split.

Config 5 of BASELINE.json (the reference is strictly single-process —
SURVEY.md §2). Layout rules for a multi-host cluster:

* the **model (TP) axis stays inside one host's cards** so its two psums
  per layer and the logits all-gather ride NVLink;
* the **data axis spans hosts** over the network — the only cross-host traffic is
  then batch-parallel (none per decode step), which is what makes ≥85 %
  scaling efficiency reachable;
* requests are routed to hosts by stable hash (cross-host batching): each
  host's scheduler admits its own subset, every process executes the same
  jitted step over the global mesh (standard JAX multi-controller SPMD);
* optional prefill/decode disaggregation: hosts can be role-tagged so
  prefill (compute-bound, bursty) runs on dedicated hosts whose outputs
  are inserted into decode hosts' caches via `Engine.prefill_standalone`
  + `insert_sequence`. The cross-process KV chunk transfer is
  `runtime.kv_transfer`: the insert tuple crosses the host boundary as a
  byte-exact serialized frame (prefill_server / RemotePrefillClient;
  `serve(roles=..., transport=...)` wires both ends).

Single-host fallback: everything degrades to the plain (data, model) mesh
— the harness in tools/bench_scaling.py measures scaling on a virtual CPU
mesh the same way it would on a cluster.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from .sharding import DATA_AXIS, MODEL_AXIS


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the JAX distributed runtime (no-op if already up or
    single-process). Without arguments JAX auto-detects a cluster from the
    environment (SLURM, Open MPI, ...); where none is found the process
    runs alone. On a machine JAX knows nothing about, pass
    `coordinator_address` (e.g. "localhost:<port>"), `num_processes` and
    `process_id` explicitly."""
    if jax.process_count() > 1:
        return  # already initialized
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except ValueError as e:
            # the one error of a process with no cluster around it
            if "coordinator_address should be defined" not in str(e):
                raise
            return
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_multihost_mesh(n_model: int | None = None) -> Mesh:
    """(data, model) mesh with the model axis contained in each host.

    Devices are laid out host-major: data axis = (hosts x per-host data
    groups) so DCN only carries the data dimension; model stays on ICI.
    """
    devices = jax.devices()
    n_local = len([d for d in devices if d.process_index == devices[0].process_index])
    n_hosts = max(jax.process_count(), 1)
    if n_model is None:
        n_model = n_local
    if n_model > n_local:
        raise ValueError(
            f"model axis {n_model} exceeds per-host device count {n_local}: "
            "TP collectives would cross DCN"
        )
    if n_local % n_model:
        raise ValueError(f"per-host devices {n_local} not divisible by tp={n_model}")
    # host-major order: [host0 devs, host1 devs, ...]; reshape so the model
    # axis indexes within a host
    arr = np.asarray(sorted(devices, key=lambda d: (d.process_index, d.id)))
    arr = arr.reshape(n_hosts * (n_local // n_model), n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def route_request(request_id: str, n_hosts: int | None = None) -> int:
    """Stable host assignment for cross-host batching."""
    import zlib

    n = n_hosts if n_hosts is not None else max(jax.process_count(), 1)
    return zlib.crc32(request_id.encode()) % n


def local_requests(requests: Sequence, n_hosts: int | None = None) -> list:
    """The subset of `requests` this process admits (by stable hash of
    request id). Every process must call this with the SAME request list."""
    me = jax.process_index()
    return [r for r in requests if route_request(getattr(r, "id", str(r)), n_hosts) == me]


@dataclasses.dataclass(frozen=True)
class HostRoles:
    """Optional prefill/decode disaggregation: which processes prefill and
    which decode. Defaults to every host doing both."""

    prefill_hosts: tuple[int, ...]
    decode_hosts: tuple[int, ...]

    @classmethod
    def uniform(cls, n_hosts: int | None = None) -> "HostRoles":
        n = n_hosts if n_hosts is not None else max(jax.process_count(), 1)
        all_hosts = tuple(range(n))
        return cls(all_hosts, all_hosts)

    @classmethod
    def disaggregated(cls, n_prefill: int, n_hosts: int | None = None) -> "HostRoles":
        """First `n_prefill` hosts prefill, the rest decode (config 5's
        prefill/decode split across hosts)."""
        n = n_hosts if n_hosts is not None else max(jax.process_count(), 1)
        if not 0 < n_prefill < n:
            raise ValueError(f"need 0 < n_prefill < {n}")
        return cls(tuple(range(n_prefill)), tuple(range(n_prefill, n)))

    def is_prefill(self, pid: int | None = None) -> bool:
        return (pid if pid is not None else jax.process_index()) in self.prefill_hosts

    def is_decode(self, pid: int | None = None) -> bool:
        return (pid if pid is not None else jax.process_index()) in self.decode_hosts


def scaling_efficiency(tokens_per_sec: dict[int, float]) -> dict[int, float]:
    """Efficiency vs linear scaling from the smallest measured mesh."""
    base_n = min(tokens_per_sec)
    base = tokens_per_sec[base_n] / base_n
    return {n: tokens_per_sec[n] / (n * base) for n in sorted(tokens_per_sec)}
