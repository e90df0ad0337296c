"""Benchmark timing, metrics, and the per-device roofline model.

SURVEY.md §5/§6: the reference ships only a Go benchmark harness with no
recorded numbers; this module reports achieved GB/s and GFLOP/s against
the device's published peaks.  The peak table is keyed by JAX's
`device_kind`; a device that is not in it is an error, never a default.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "BenchResult",
    "PEAKS",
    "time_fn",
    "roofline",
    "device_peaks",
    "hbm_bandwidth_gbs",
    "fft_flops",
    "fft_bytes",
    "copy_floor",
    "matmul_floor",
]

# Published dense peaks per device, keyed by jax Device.device_kind.
# Source: NVIDIA H200 SXM data sheet (700 W power limit): 141 GB HBM3e at
# 4.8 TB/s; 67 TFLOP/s float32 outside the tensor cores; 495 TFLOP/s
# TF32 and 989 TFLOP/s bf16 on the tensor cores, without sparsity.
PEAKS = {
    "NVIDIA H200": {
        "hbm_gbs": 4800.0,
        "fp32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
    },
}


def device_peaks(device=None) -> dict:
    """Published peaks of the given (default: first) device.

    Raises KeyError for a device_kind not in PEAKS.
    """
    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add it to PEAKS")
    return PEAKS[kind]


def hbm_bandwidth_gbs(device=None) -> float:
    """Peak HBM GB/s of the given (default: first) device."""
    return device_peaks(device)["hbm_gbs"]


def fft_flops(n: int, batch: int = 1) -> float:
    """Standard FFT flop count: 5 N log2 N per transform."""
    return 5.0 * n * math.log2(n) * batch


def fft_bytes(n: int, batch: int, bytes_per_element: int = 8) -> float:
    """Least HBM traffic for a batched FFT: one read + one write of the
    complex array (c64 = 8 bytes/element)."""
    return 2.0 * n * batch * bytes_per_element


@dataclass
class BenchResult:
    name: str
    wall_s: float
    flops: float = 0.0
    bytes_moved: float = 0.0

    @property
    def gflops(self) -> float:
        return self.flops / self.wall_s / 1e9 if self.wall_s else 0.0

    @property
    def gbs(self) -> float:
        return self.bytes_moved / self.wall_s / 1e9 if self.wall_s else 0.0

    def roofline_fraction(self, peak_gbs: Optional[float] = None) -> float:
        """Achieved bytes/s over the peak (default: the device's HBM
        peak from PEAKS; raises for an unknown device)."""
        peak = peak_gbs if peak_gbs is not None else hbm_bandwidth_gbs()
        return self.gbs / peak

    def json_line(self, **extra) -> str:
        d = asdict(self)
        d.update(gflops=self.gflops, gbs=self.gbs, **extra)
        return json.dumps(d)


def time_fn(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    name: str = "bench",
    flops: float = 0.0,
    bytes_moved: float = 0.0,
) -> BenchResult:
    """Median-of-iters wall time of fn(*args), blocking on the result.

    Warmup iterations absorb compilation (the analogue of the reference
    pre-warming twiddles before its timed region, fft_test.go:262-280).
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    return BenchResult(name=name, wall_s=med, flops=flops, bytes_moved=bytes_moved)


def copy_floor(n_bytes: int, iters: int = 10) -> BenchResult:
    """Time a plain device copy of an n_bytes float32 array: what the
    memory system reaches in practice, measured beside a kernel so the
    kernel's bytes/s can be read against it (read + write counted)."""
    x = jnp.zeros(n_bytes // 4, jnp.float32)
    copy = jax.jit(lambda a: a + 1.0)
    return time_fn(copy, x, iters=iters, name="copy_floor", bytes_moved=2.0 * x.nbytes)


def matmul_floor(n: int, iters: int = 10) -> BenchResult:
    """Time an (n, n) x (n, n) bf16 matrix product with float32
    accumulation: what the tensor cores reach in practice."""
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda p, q: jnp.matmul(p, q, preferred_element_type=jnp.float32))
    return time_fn(mm, a, a, iters=iters, name="matmul_floor", flops=2.0 * n**3)


def roofline(n: int, batch: int, wall_s: float, bytes_per_element: int = 8) -> dict:
    """Roofline summary for a batched n-point FFT run."""
    moved = fft_bytes(n, batch, bytes_per_element)
    peak = hbm_bandwidth_gbs()
    gbs = moved / wall_s / 1e9
    return {
        "n": n,
        "batch": batch,
        "wall_s": wall_s,
        "gflops": fft_flops(n, batch) / wall_s / 1e9,
        "gbs": gbs,
        "peak_gbs": peak,
        "roofline_fraction": gbs / peak,
    }
