"""Four-step (Bailey) FFT: DFT as batched matmuls, time-major layout.

The power-of-2 FFT of the framework, for single and batched transforms.
Where the reference streams butterflies through a goroutine
pool (fft/radix2.go:80-153), this factors the N-point DFT as
N = N1 x N2 and computes

    X[k1 + N1*k2] = sum_n2 [ e^{-2i pi n2 k1 / N}
                     * (sum_n1 x[N2*n1 + n2] e^{-2i pi n1 k1 / N1}) ]
                     * e^{-2i pi n2 k2 / N2}

i.e. column DFTs (complex matmul), a twiddle multiply (fused
elementwise), and row DFTs (matmul), recursing until the factor is <= 64
and a direct DFT matrix applies.  All contractions run at
Precision.HIGHEST (full float32; on a GPU the default precision would be
TF32, and bf16 would cap accuracy near 47 dB, far below the 120 dB
parity bound).

Layout discipline: everything is TIME-MAJOR — the transform axis is
axis 0 and the batch stays minor — so every intermediate keeps a large
contiguous trailing dimension.  One transpose in and one out convert
from the public (batch, N) layout.

Twiddle/DFT tables are float64 numpy constants built once per size at
trace time (the analogue of the reference's RWMutex-guarded caches,
radix2.go:26-69).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["four_step_fft", "fft_time_major", "dft_matrix", "twiddle_2d"]

_HI = jax.lax.Precision.HIGHEST

# Largest factor solved by one direct DFT-matrix multiply: bounds the
# O(N1+N2) work per element.
_DIRECT_N = 64


@lru_cache(maxsize=None)
def dft_matrix(n: int) -> np.ndarray:
    """Dense n-point DFT matrix, float64: F[k, j] = exp(-2i pi k j / n)."""
    k = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


@lru_cache(maxsize=None)
def twiddle_2d(n1: int, n2: int) -> np.ndarray:
    """Four-step twiddle table T[i, j] = exp(-2i pi i j / (n1 n2))."""
    i = np.arange(n1, dtype=np.float64)
    j = np.arange(n2, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(i, j) / (n1 * n2))


def _split_factor(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n1 the larger power-of-2 half (n1 >= n2)."""
    l2 = n.bit_length() - 1
    n1 = 1 << (l2 - l2 // 2)
    return n1, n // n1


def fft_time_major(t: jax.Array, inverse: bool = False) -> jax.Array:
    """DFT over axis 0 of a (N, ...batch) complex array; N a power of 2.

    Unnormalized forward transform (inverse conjugates the tables, still
    unnormalized — the public ifft handles the 1/N).  Jitted, so the
    numpy tables embed as trace constants.
    """
    n = t.shape[0]
    if n & (n - 1):
        raise ValueError(f"fft_time_major requires a power-of-2 length, got {n}")
    if n <= 1:
        return t
    from godsp_tpu._dtypes import put

    return _fft_tm_jit(put(t), inverse)


@partial(jax.jit, static_argnames=("inverse",))
def _fft_tm_jit(t: jax.Array, inverse: bool) -> jax.Array:
    return _fft_tm(t, inverse)


def _const(tab: np.ndarray, dtype, inverse: bool) -> jax.Array:
    return jnp.asarray(np.conj(tab) if inverse else tab, dtype=dtype)


def _fft_tm(t: jax.Array, inverse: bool) -> jax.Array:
    n = t.shape[0]
    if n <= _DIRECT_N:
        F = _const(dft_matrix(n), t.dtype, inverse)
        return jnp.tensordot(F, t, axes=((1,), (0,)), precision=_HI)

    n1, n2 = _split_factor(n)
    rest = t.shape[1:]
    tm = t.reshape(n1, n2, *rest)  # n = N2*i1 + i2 (row-major)

    # Step 1: DFT over n1 (axis 0).  n1 is always <= some power where one
    # more recursion bottoms out in a direct matrix.
    if n1 <= _DIRECT_N:
        F1 = _const(dft_matrix(n1), t.dtype, inverse)
        A = jnp.tensordot(F1, tm, axes=((1,), (0,)), precision=_HI)
    else:
        A = _fft_tm(tm.reshape(n1, -1), inverse).reshape(n1, n2, *rest)

    # Step 2: twiddle multiply (fuses into the adjacent matmul).
    T = _const(twiddle_2d(n1, n2), t.dtype, inverse).reshape(
        n1, n2, *([1] * len(rest))
    )
    B = A * T

    # Step 3: DFT over n2 (axis 1), keeping the batch minor.
    if n2 <= _DIRECT_N:
        F2 = _const(dft_matrix(n2), t.dtype, inverse)
        flat = B.reshape(n1, n2, -1)
        C = jnp.einsum("mn,knb->kmb", F2, flat, precision=_HI).reshape(
            n1, n2, *rest
        )
    else:
        y = jnp.swapaxes(B, 0, 1).reshape(n2, -1)
        C = _fft_tm(y, inverse).reshape(n2, n1, *rest)
        C = jnp.swapaxes(C, 0, 1)

    # Step 4: output index k = k1 + N1*k2 — swap (k1, k2) and flatten.
    return jnp.swapaxes(C, 0, 1).reshape(n, *rest)


def four_step_fft(x: jax.Array, inverse: bool = False) -> jax.Array:
    """Batched DFT of the trailing axis via the four-step factorization.

    x: (..., N) complex, N a power of 2.  Transposes to time-major,
    transforms, transposes back.
    """
    from godsp_tpu._dtypes import put

    x = put(x)
    n = x.shape[-1]
    if n <= 1:
        return x
    if x.ndim == 1:
        return fft_time_major(x[:, None], inverse)[:, 0]
    lead = x.shape[:-1]
    t = jnp.moveaxis(x.reshape(-1, n), 0, 1)  # (N, B)
    y = fft_time_major(t, inverse)
    return jnp.moveaxis(y, 0, 1).reshape(*lead, n)
