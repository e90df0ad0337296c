"""Stockham autosort radix-2 FFT, pure JAX, batched over leading axes.

Vectorized replacement for the reference's bit-reversal decimation-in-time
kernel (fft/radix2.go:80-153).  Bit-reversal reordering is a scatter —
hostile to wide vector layouts — so this uses the self-sorting
Stockham formulation instead: log2(N) stages of slice / butterfly /
concatenate, all unit-stride, with the inter-stage "transpose" folded into
the concatenate.  Output is in natural order with no reorder pass.

The goroutine worker pool + per-stage WaitGroup barrier of the reference
(radix2.go:89-151) maps to: vectorization across the batch axes inside one
XLA computation (intra-device), and mesh sharding of the batch axis
(cross-device, see godsp_tpu.parallel).

Twiddle factors are generated host-side in float64 once per (N, sign) and
cached — the analogue of the reference's RWMutex-guarded lazy table
(radix2.go:26-69) with the locks erased by trace-time construction.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import complex_for

__all__ = ["stockham_fft", "ensure_radix2_factors", "twiddles"]


@lru_cache(maxsize=None)
def _twiddles_f64(L: int, sign: int) -> np.ndarray:
    """exp(sign * 2i*pi * k / L) for k in [0, L/2), float64."""
    k = np.arange(L // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / L
    return np.cos(ang) + 1j * np.sin(ang)


def twiddles(L: int, sign: int, dtype) -> jnp.ndarray:
    return jnp.asarray(_twiddles_f64(L, sign), dtype=dtype)


def ensure_radix2_factors(n: int) -> None:
    """Pre-warm twiddle tables for all power-of-2 sizes up to n.

    API-parity with fft.EnsureRadix2Factors (fft/fft.go:103-107 /
    radix2.go:32-37); useful to keep table construction out of timed
    benchmark regions.
    """
    L = 4
    while L <= n:
        _twiddles_f64(L, -1)
        _twiddles_f64(L, +1)
        L *= 2


def stockham_fft(x: jax.Array, inverse: bool = False) -> jax.Array:
    """Radix-2 FFT of the trailing axis; length must be a power of 2.

    x: (..., N) complex.  Forward transform, unnormalized (the 1/N inverse
    scale lives in the public ifft, matching fft/fft.go:47-50).

    Runs TIME-MAJOR internally: the stage state is (L, M*B) with the
    batch minor, so every butterfly keeps a large contiguous trailing
    dimension.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"stockham_fft requires a power-of-2 length, got {n}")
    x = jnp.asarray(x)
    cdtype = complex_for(x.dtype)
    x = x.astype(cdtype)
    if n <= 1:
        return x
    sign = 1 if inverse else -1

    lead = x.shape[:-1]
    t = jnp.moveaxis(x.reshape(-1, n), 0, 1)  # (N, B) time-major

    # State invariant: t is (L, M*B) holding M interleaved sub-transforms
    # of remaining length L over B batch lanes (M-major in the merged
    # axis); concatenating the butterfly halves along it performs the
    # Stockham self-sort with unit-stride accesses throughout.
    L = n
    while L > 1:
        half = L // 2
        w = twiddles(L, sign, cdtype)  # (half,)
        a = t[:half]
        b = t[half:]
        t = jnp.concatenate([a + b, (a - b) * w[:, None]], axis=1)
        L = half

    return jnp.moveaxis(t.reshape(n, -1), 0, 1).reshape(*lead, n)
