"""Public FFT API: dispatch, inverse, convolution, 2-D/N-D drivers.

Counterpart of reference fft/fft.go.  Semantics preserved:

  * dispatch by length: <=1 copy-through, power-of-2 radix path, else
    Bluestein (fft.go:72-87);
  * IFFT = index-reversal (mod N) + forward FFT + 1/N scale — the 1/N
    normalization lives on the inverse only (fft.go:35-52);
  * fft_real returns the FULL N-bin spectrum of a real input, not the
    one-sided packing (fft.go:25-27);
  * error conditions that panic in the reference raise ValueError here
    (Convolve unequal lengths fft.go:56-58; FFT2 empty/ragged
    fft.go:125-134).

Everything is batched over leading axes and jit-compatible: dispatch is
static on shapes, so each distinct length traces once.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Union

import jax
import jax.numpy as jnp

from godsp_tpu._dtypes import as_complex_array, put
from godsp_tpu.dsputils.matrix import Matrix
from godsp_tpu.dsputils.utils import is_power_of_2
from godsp_tpu.fft.bluestein import bluestein_fft
from godsp_tpu.fft.pow2 import pow2_fft
from godsp_tpu.fft.stockham import ensure_radix2_factors

__all__ = [
    "fft",
    "ifft",
    "fft_real",
    "ifft_real",
    "convolve",
    "fft2",
    "ifft2",
    "fft2_real",
    "ifft2_real",
    "fftn",
    "ifftn",
    "ensure_radix2_factors",
]


# The whole transform compiles into one XLA computation per
# (shape, dtype) via jit.  The thin public wrappers move host inputs to
# the device with put().


@partial(jax.jit, static_argnames=("axis",))
def _fft_jit(x, axis: int = -1) -> jax.Array:
    x = as_complex_array(x)
    if axis not in (-1, x.ndim - 1):
        x = jnp.moveaxis(x, axis, -1)
        return jnp.moveaxis(_fft_last(x), -1, axis)
    return _fft_last(x)


def fft(x, axis: int = -1) -> jax.Array:
    """Forward DFT along `axis` (default trailing), batched over the rest.

    Dispatch mirrors fft.FFT (fft.go:72-87): length <= 1 is returned
    as-is, power-of-2 lengths take the power-of-2 path (fft/pow2.py),
    everything else takes Bluestein.
    """
    return _fft_jit(put(x), axis=axis)


def _fft_last(x: jax.Array) -> jax.Array:
    n = x.shape[-1]
    if n <= 1:
        return x
    if is_power_of_2(n):
        # The four-step path (fft/pow2.py dispatch); the Stockham kernel
        # remains available as an independent oracle (fft/stockham.py).
        return pow2_fft(x)
    return bluestein_fft(x)


@partial(jax.jit, static_argnames=("axis",))
def _ifft_jit(x, axis: int = -1) -> jax.Array:
    x = as_complex_array(x)
    n = x.shape[axis]
    if n <= 1:
        return x
    if is_power_of_2(n):
        # Conjugate-table inverse: mathematically identical to the
        # reference's index-reversal + forward FFT (fft.go:35-52) —
        # sum_j x[j] e^{+2pi i jk/N} — without the flip/roll passes.
        if axis not in (-1, x.ndim - 1):
            x = jnp.moveaxis(x, axis, -1)
            return jnp.moveaxis(pow2_fft(x, inverse=True) / n, -1, axis)
        return pow2_fft(x, inverse=True) / n
    # y[0] = x[0], y[i] = x[n-i]  (fft.go:39-43)
    rev = jnp.roll(jnp.flip(x, axis=axis), 1, axis=axis)
    return _fft_jit(rev, axis=axis) / n


def ifft(x, axis: int = -1) -> jax.Array:
    """Inverse DFT along `axis`: reverse indices mod N, forward FFT,
    scale by 1/N (fft.go:35-52)."""
    return _ifft_jit(put(x), axis=axis)


def fft_real(x, axis: int = -1) -> jax.Array:
    """FFT of real input; returns the full N-bin complex spectrum
    (fft.go:25-27).  The real->complex lift happens inside the jitted
    transform."""
    return _fft_jit(put(x), axis=axis)


@partial(jax.jit, static_argnames=("axis",))
def _ifft_real_jit(x, axis: int) -> jax.Array:
    n = x.shape[axis]
    if x.dtype.kind == "f" and n > 1:
        # For real x: IFFT(x) = conj(FFT(x))/n — no index-reversal passes.
        return jnp.conj(_fft_jit(x, axis=axis)) / n
    return _ifft_jit(x, axis=axis)


def ifft_real(x, axis: int = -1) -> jax.Array:
    """IFFT of real input (fft.go:30-32)."""
    return _ifft_real_jit(put(x), axis=axis)


@jax.jit
def _convolve_impl(x, y):
    from godsp_tpu.fft.pow2 import pow2_convolve

    x = as_complex_array(x)
    y = as_complex_array(y)
    n = x.shape[-1]
    if n > 1 and is_power_of_2(n):
        # Power-of-2: one chain of forward, multiply, inverse with the
        # 1/N folded in.
        return pow2_convolve(x, y, scale=1.0 / n)
    return ifft(fft(x) * fft(y))


def convolve(x, y) -> jax.Array:
    """Circular convolution of equal-length arrays via FFT (fft.go:55-69).

    Batched over leading axes; raises ValueError where the reference
    panics on unequal trailing lengths.
    """
    x = put(x)
    y = put(y)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("arrays not of equal size")
    return _convolve_impl(x, y)


# ---------------------------------------------------------------------------
# 2-D / N-D drivers.  The reference gathers one lane at a time through a
# strided odometer (fft.go:123-154, 166-224); here the same math is a
# transpose-to-minor-axis + batched 1-D transform per axis.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("inverse",))
def _fft2_jit(x, inverse: bool) -> jax.Array:
    op = ifft if inverse else fft
    # Column pass then row pass (fft.go:138-151); order is immaterial.
    x = op(x, axis=0)
    return op(x, axis=1)


def _fft2_impl(x, inverse: bool) -> jax.Array:
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError("fft2 requires a 2-D input")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError("empty input array")  # fft.go:125-127
    return _fft2_jit(x, inverse)


def _as_2d(x) -> jax.Array:
    """Validate a (possibly nested-list) 2-D input; raises on ragged rows
    (fft.go:129-134)."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("empty input array")
        width = len(x[0])
        for row in x:
            if len(row) != width:
                raise ValueError("ragged input array")
    arr = put(x)
    if arr.ndim != 2:
        raise ValueError("fft2 requires a 2-D input")
    return arr


def fft2(x) -> jax.Array:
    """2-D forward DFT (fft.go:109-111)."""
    return _fft2_impl(_as_2d(x), inverse=False)


def ifft2(x) -> jax.Array:
    """2-D inverse DFT (fft.go:119-121)."""
    return _fft2_impl(_as_2d(x), inverse=True)


def fft2_real(x) -> jax.Array:
    """2-D DFT of real input (fft.go:104-106)."""
    return fft2(x)


def ifft2_real(x) -> jax.Array:
    """2-D inverse DFT of real input (fft.go:114-116)."""
    return ifft2(x)


MatrixLike = Union[Matrix, jax.Array, Sequence]


@partial(jax.jit, static_argnames=("inverse",))
def _fftn_jit(arr, inverse: bool):
    op = ifft if inverse else fft
    # One batched 1-D pass per axis (replaces the per-lane odometer of
    # fft.go:166-224 with transpose + vectorized transform).
    for axis in range(arr.ndim):
        arr = op(arr, axis=axis)
    return arr


def _fftn_impl(m: MatrixLike, inverse: bool):
    from godsp_tpu.utils.host import to_host

    is_matrix = isinstance(m, Matrix)
    arr = put(m.array if is_matrix else m)
    out = _fftn_jit(arr, inverse)
    return Matrix.from_array(to_host(out)) if is_matrix else out


def fftn(m: MatrixLike):
    """N-D forward DFT over a Matrix or array (fft.go:157-159)."""
    return _fftn_impl(m, inverse=False)


def ifftn(m: MatrixLike):
    """N-D inverse DFT over a Matrix or array (fft.go:162-164)."""
    return _fftn_impl(m, inverse=True)
