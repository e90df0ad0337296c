"""Continuous wavelet transform as ONE batched convolution bank.

scipy.signal's classic cwt/ricker/morlet surface (removed from scipy in
1.15 in favor of PyWavelets — the semantics here follow the classic
definitions, with an independent numpy oracle in tests/test_wavelets.py).

Shape: instead of scipy's per-width Python loop of separate
convolutions, all W wavelet kernels are zero-padded to the widest
length and convolved with the signal in ONE batched kernel-chain FFT
launch; per-width 'same' alignment is a single gather on the full
outputs (trailing zero taps shift nothing).  The scalogram therefore
costs one forward FFT of the signal + W pointwise products, batched.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_complex_array, default_float, put
from godsp_tpu.dsputils.utils import next_power_of_2
from godsp_tpu.fft.pow2 import pow2_fft

__all__ = ["cwt", "morlet", "morlet2", "ricker"]


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker (Mexican-hat) wavelet: the normalized negative second
    derivative of a Gaussian of width a (classic scipy.signal.ricker)."""
    points = int(points)
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    vec = np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0
    xsq = (vec / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


def morlet(M: int, w: float = 5.0, s: float = 1.0,
           complete: bool = True) -> np.ndarray:
    """Classic Morlet wavelet on [-s*2pi, s*2pi] (scipy.signal.morlet):
    exp(1j w x) Gaussian, with the admissibility correction term when
    complete=True."""
    x = np.linspace(-s * 2 * np.pi, s * 2 * np.pi, int(M))
    out = np.exp(1j * w * x).astype(complex)
    if complete:
        out -= np.exp(-0.5 * w**2)
    out *= np.exp(-0.5 * x**2) * np.pi ** (-0.25)
    return out


def morlet2(M: int, s: float, w: float = 5.0) -> np.ndarray:
    """Morlet wavelet parameterized for cwt (scipy.signal.morlet2):
    unit-energy complex exponential under a Gaussian of width s."""
    x = (np.arange(int(M), dtype=np.float64) - (int(M) - 1.0) / 2.0) / s
    wave = np.exp(1j * w * x) * np.exp(-0.5 * x**2) * np.pi ** (-0.25)
    return np.sqrt(1.0 / s) * wave


@partial(jax.jit, static_argnames=("n", "real_out"))
def _cwt_bank_jit(data_c, bank_c, starts, n: int, real_out: bool):
    """Full convolution of data with every (zero-padded) kernel in one
    batched chain, then per-row 'same' windows via a single gather."""
    lmax = bank_c.shape[-1]
    nfft = next_power_of_2(n + lmax - 1)
    dpad = jnp.pad(data_c, (0, nfft - n))
    bpad = jnp.pad(bank_c, [(0, 0), (0, nfft - lmax)])
    D = pow2_fft(dpad)
    B = pow2_fft(bpad)
    full = pow2_fft(D[None, :] * B, inverse=True) * (1.0 / nfft)
    idx = starts[:, None] + jnp.arange(n)[None, :]
    out = jnp.take_along_axis(full, idx, axis=-1)
    return jnp.real(out) if real_out else out


def cwt(data, wavelet, widths, dtype=None, **kwargs) -> jax.Array:
    """Continuous wavelet transform (classic scipy.signal.cwt
    semantics): row i is the 'same'-mode convolution of data with
    conj(reversed wavelet(min(10*widths[i], len(data)), widths[i])).
    All rows run as ONE batched FFT-convolution launch."""
    data = put(data)
    if data.ndim != 1:
        raise ValueError("data must be 1-D")
    n = data.shape[0]
    if n == 0:
        raise ValueError("empty data")
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if widths.ndim != 1 or widths.size == 0 or np.any(widths <= 0):
        raise ValueError("widths must be positive and 1-D")
    kernels = []
    for wdt in widths:
        length = int(min(10 * wdt, n))
        if length < 1:
            length = 1
        k = np.conj(np.asarray(wavelet(length, wdt, **kwargs))[::-1])
        kernels.append(k)
    lens = np.array([len(k) for k in kernels])
    lmax = int(lens.max())
    complex_bank = any(np.iscomplexobj(k) for k in kernels)
    bank = np.zeros((len(kernels), lmax),
                    np.complex128 if complex_bank else np.float64)
    for i, k in enumerate(kernels):
        bank[i, : len(k)] = k
    starts = (lens - 1) // 2  # 'same' crop offset per kernel length
    fdt = default_float()
    data_c = as_complex_array(data.real.astype(fdt)
                              if data.dtype.kind != "c" else data)
    bank_j = put(bank)
    real_out = data.dtype.kind != "c" and not complex_bank
    return _cwt_bank_jit(data_c, as_complex_array(bank_j),
                         jnp.asarray(starts, jnp.int32), n, real_out)
