"""Bluestein chirp-z FFT for arbitrary lengths (reference fft/bluestein.go).

Expresses an N-point DFT as a circular convolution at the next power of 2
>= 2N-1, evaluated with the Stockham kernel.  Improvements over the
reference, all below the 1e-8 parity tolerance (SURVEY.md appendix #9):

  * chirp phases use mod-2N argument reduction in exact integer
    arithmetic (bluestein.go:53 squares in int and feeds sin an unreduced
    argument — overflow for N > 46340, precision decay before that);
  * FFT(b), which depends only on N, is precomputed and cached as a
    trace-time constant (the reference recomputes it every call —
    SURVEY.md §3.2).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import complex_for
from godsp_tpu.dsputils.utils import next_power_of_2
from godsp_tpu.fft.pow2 import pow2_circular_filter

__all__ = ["bluestein_fft"]


@lru_cache(maxsize=None)
def _chirp_tables_f64(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(w, fft_b): chirp w[i] = exp(+i*pi*i^2/n) and FFT of the symmetric
    chirp filter b at padded length la = next_pow2(2n-1).

    Matches bluestein.go:44-58 (tables) and :78-87 (b construction) with
    exact i^2 mod 2n reduction via Python ints.
    """
    la = next_power_of_2(2 * n - 1)
    i = np.arange(n, dtype=object)  # exact ints: i*i never overflows
    isq_mod = np.array([(int(v) * int(v)) % (2 * n) for v in i], dtype=np.float64)
    ang = np.pi * isq_mod / n
    w = np.cos(ang) + 1j * np.sin(ang)

    b = np.zeros(la, dtype=np.complex128)
    b[0] = w[0]
    if n > 1:
        b[1:n] = w[1:n]
        b[la - n + 1 :] = w[1:n][::-1]  # b[la-i] = w[i], i in [1, n)
    fft_b = np.fft.fft(b)  # trace-time constant, float64 throughout
    return w, fft_b


def bluestein_fft(x: jax.Array) -> jax.Array:
    """Arbitrary-length forward DFT of the trailing axis via chirp-z.

    x: (..., N) complex.  Batched over leading axes.  Unnormalized; the
    public ifft reaches this through index-reversal (fft/fft.go:35-52), so
    no separate inverse path is needed.  Jitted, so the chirp tables
    embed as trace constants.
    """
    from godsp_tpu._dtypes import put

    return _bluestein_jit(put(x))


@jax.jit
def _bluestein_jit(x: jax.Array) -> jax.Array:
    n = x.shape[-1]
    cdtype = complex_for(x.dtype)
    x = x.astype(cdtype)
    if n <= 1:
        return x

    w_np, fft_b_np = _chirp_tables_f64(n)
    la = next_power_of_2(2 * n - 1)
    w = jnp.asarray(w_np, dtype=cdtype)
    fft_b = jnp.asarray(fft_b_np, dtype=cdtype)

    # Premultiply by the conjugate chirp and zero-pad (bluestein.go:70-76).
    a = x * jnp.conj(w)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, la - n)]
    a = jnp.pad(a, pad)

    # Circular convolution with the chirp filter; FFT(b) is precomputed
    # and the 1/la inverse normalization is folded into it (pow2.py).
    conv = pow2_circular_filter(a, fft_b, scale=1.0 / la)

    # Postmultiply and truncate (bluestein.go:89-93).
    return conv[..., :n] * jnp.conj(w)
