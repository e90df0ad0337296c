"""Split-complex public FFT: transforms over separate (re, im) planes.

Many DSP pipelines keep real and imaginary parts as two float arrays.
These wrappers take and return such planes and run the same complex
dispatch as fft/core.py; the inverse's 1/N is the reference's
convention (fft.go:47-50).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["fft_split", "ifft_split", "rfft_split"]


def fft_split(xr, xi=None):
    """Natural-order forward DFT over split planes (..., N) -> (yr, yi).

    xi=None means a real input.  Matches fft.fft on lax.complex(xr, xi)
    bin for bin.
    """
    from godsp_tpu.fft.core import fft as cfft

    xr = jnp.asarray(xr)
    if xi is not None:
        xi = jnp.asarray(xi)
        if xr.shape != xi.shape:
            raise ValueError("re/im planes must have identical shapes")
    if xr.shape[-1] <= 1:
        return xr, (jnp.zeros_like(xr) if xi is None else xi)
    z = cfft(xr if xi is None else jax.lax.complex(xr, xi))
    return jnp.real(z), jnp.imag(z)


def ifft_split(yr, yi):
    """Normalized inverse DFT over split planes: fft.ifft semantics
    (1/N on the inverse, fft.go:47-50)."""
    from godsp_tpu.fft.core import ifft as cifft

    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    if yr.shape != yi.shape:
        raise ValueError("re/im planes must have identical shapes")
    if yr.shape[-1] <= 1:
        return yr, yi
    z = cifft(jax.lax.complex(yr, yi))
    return jnp.real(z), jnp.imag(z)


def rfft_split(xr):
    """One-sided forward DFT of a REAL plane (..., N) -> (yr, yi) planes
    of shape (..., N//2 + 1), numpy.fft.rfft bin layout: the first
    N//2 + 1 bins of the full transform (FFTReal, fft/fft.go:25-32)."""
    xr = jnp.asarray(xr)
    n = xr.shape[-1]
    if n <= 1:
        return xr, jnp.zeros_like(xr)
    yr, yi = fft_split(xr, None)
    return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]
