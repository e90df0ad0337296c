"""Power-of-2 FFT dispatcher.

The single choke point every power-of-2 transform in the framework goes
through (public fft/ifft dispatch, Convolve, and Bluestein's internal
convolution).  Every transform takes the four-step formulation
(fft/four_step.py): batched complex matrix products at
Precision.HIGHEST, which XLA hands to the GPU's BLAS library.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from godsp_tpu.fft.four_step import four_step_fft

__all__ = ["pow2_convolve2", "pow2_fft"]


def pow2_fft(x: jax.Array, inverse: bool = False) -> jax.Array:
    """Unnormalized DFT of the trailing power-of-2 axis, batched."""
    if x.shape[-1] <= 1:
        return x
    return four_step_fft(x, inverse)


def pow2_circular_filter(x: jax.Array, h: jax.Array, scale: float = 1.0) -> jax.Array:
    """scale * IDFT(DFT(x) * h_freq): the Convolve/Bluestein core.

    h: the frequency response in natural bin order (same trailing length
    as x; broadcastable leading dims).  scale (e.g. 1/N) is folded into
    the response before the inverse.
    """
    return pow2_fft(pow2_fft(x) * (h * scale), inverse=True)


def pow2_convolve(x: jax.Array, y: jax.Array, scale: float = 1.0) -> jax.Array:
    """scale * IDFT(DFT(x) * DFT(y)) over the trailing power-of-2 axis."""
    out = pow2_fft(pow2_fft(x) * pow2_fft(y), inverse=True)
    return out * scale if scale != 1.0 else out


def pow2_convolve2(x: jax.Array, y: jax.Array, scale: float = 1.0) -> jax.Array:
    """2-D circular convolution scale * IDFT2(DFT2(x) * DFT2(y)) over the
    two trailing (power-of-2) axes, batched over leading axes."""

    def f2(c, inverse):
        c = pow2_fft(c, inverse=inverse)
        c = jnp.swapaxes(c, -1, -2)
        c = pow2_fft(c, inverse=inverse)
        return jnp.swapaxes(c, -1, -2)

    out = f2(f2(x, False) * f2(y, False), True)
    return out * scale if scale != 1.0 else out
