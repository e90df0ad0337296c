"""Device-mesh construction for the DSP pipelines.

The reference's only parallelism is an in-process goroutine pool over
butterfly blocks (fft/radix2.go:75-153).  The device-mesh equivalents
(SURVEY.md §2.2):

  * dp — data parallel over independent signals/channels;
  * sp — sequence parallel over the time axis of one long signal, with
    overlap halos exchanged between neighbor shards.

Multi-host: call init_distributed() before building the mesh;
jax.devices() then spans every process's devices and the same code runs
unchanged (collectives ride NVLink within a host, the network across
hosts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["MeshConfig", "make_mesh", "init_distributed", "P", "NamedSharding"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-process JAX; returns the global device count.

    Initializes only when asked — a coordinator address or a process
    count was given — and then needs all three arguments (no cluster is
    auto-detected).  With no arguments it is a no-op for a single
    process.  After this, jax.devices() spans every process and the
    same mesh/shard_map code runs unchanged.  Failure policy is
    fail-fast per JAX multi-host convention (SURVEY.md §5): errors from
    jax.distributed.initialize propagate; no elastic resize.
    """
    if coordinator_address is not None or num_processes is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


@dataclass(frozen=True)
class MeshConfig:
    """Frozen mesh description (no process-global knobs — the
    counterpart of the reference's SetWorkerPoolSize global,
    fft/fft.go:89-101)."""

    dp: int = 1  # data-parallel (channel/batch) axis size
    sp: int = 1  # sequence-parallel (time) axis size

    @property
    def n_devices(self) -> int:
        return self.dp * self.sp


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("dp", "sp") mesh.

    Default: all local devices on the sp axis (the streaming-Pwelch
    layout).  A plain reshape of the device list: every GPU of a host
    reaches every other over NVLink at the same rate, so the mesh
    follows the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    if config is None:
        config = MeshConfig(dp=1, sp=len(devices))
    if config.n_devices > len(devices):
        raise ValueError(
            f"mesh needs {config.n_devices} devices, have {len(devices)}"
        )
    grid = np.asarray(devices[: config.n_devices]).reshape(config.dp, config.sp)
    return Mesh(grid, ("dp", "sp"))
