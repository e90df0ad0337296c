"""Fast Hankel transform on a logarithmic grid (FFTLog; Hamilton 2000).

scipy.fft.fht/ifht/fhtoffset semantics: the order-mu Hankel transform of
a log-periodically sampled function, computed as one real FFT, a
pointwise multiply by the analytic U_mu coefficients, and an inverse
real FFT — so the compute path rides this framework's kernel chain while
the coefficient table (complex log-gamma via the classic Lanczos
approximation — no scipy dependency) is trace-time host float64.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import default_float, put
from godsp_tpu.fft.helpers import irfft, rfft

__all__ = ["fht", "fhtoffset", "ifht"]

_LANCZOS_G = 7.0
_LANCZOS = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def _loggamma(z):
    """Complex log-gamma (Lanczos g=7; reflection for Re z < 1/2) —
    ~1e-13 absolute accuracy on the FFTLog argument range."""
    z = np.asarray(z, complex)
    reflect = z.real < 0.5
    zr = np.where(reflect, 1.0 - z, z)
    # No [None, :] on the coefficient axis: scalar z must stay 0-d
    # (the (1, 8) form promoted scalars to shape (1,), tripping numpy's
    # array-to-scalar deprecation in fhtoffset's float()).
    x = _LANCZOS[0] + np.sum(
        _LANCZOS[1:] / (zr[..., None] + np.arange(len(_LANCZOS) - 1)),
        axis=-1)
    t = zr + _LANCZOS_G - 0.5
    lg = 0.5 * np.log(2 * np.pi) + (zr - 0.5) * np.log(t) - t + np.log(x)
    with np.errstate(all="ignore"):
        refl = np.log(np.pi / np.sin(np.pi * z)) - lg
    return np.where(reflect, refl, lg)


def _gamma_ratio(xp_: float, xm: float) -> float:
    """Gamma(xp)/Gamma(xm) with the negative-integer pole limits:
    0 when only Gamma(xm) poles, inf when only Gamma(xp) poles, and the
    residue ratio when both do."""
    def is_pole(v):
        return v <= 0 and v == int(v)

    if is_pole(xp_) and is_pole(xm):
        # lim Gamma(xp+e)/Gamma(xm+e) = (-1)^(xm-xp) Gamma(1-xm)/Gamma(1-xp)
        sign = -1.0 if (int(xm - xp_) % 2) else 1.0
        return sign * float(
            np.exp(_loggamma(1.0 - xm) - _loggamma(1.0 - xp_)).real)
    if is_pole(xm):
        return 0.0
    if is_pole(xp_):
        return np.inf
    return float(np.exp(_loggamma(xp_) - _loggamma(xm)).real)


def _fhtcoeff(n: int, dln: float, mu: float, offset: float, bias: float,
              inverse: bool) -> np.ndarray:
    """u_m = (kr)^{-2 pi i m/(n dln)} U_mu(q + 2 pi i m/(n dln)),
    U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2)."""
    lnkr, q = float(offset), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi * np.arange(n // 2 + 1) / (n * dln)
    lg = (_loggamma(xp_ + 1j * y) - np.conj(_loggamma(xm + 1j * y))
          + np.log(2.0) * q + 2j * y * (np.log(2.0) - lnkr))
    u = np.exp(lg)
    if n % 2 == 0:
        u.imag[-1] = 0.0  # Nyquist coefficient is real
    if not np.isfinite(u[0]):
        u[0] = 2.0**q * _gamma_ratio(xp_, xm)
    if np.isinf(u[0]) and not inverse:
        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=3)
        u = u.copy()
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        warnings.warn("singular inverse transform; consider changing the "
                      "bias", stacklevel=3)
        u = u.copy()
        u[0] = np.inf
    return u


def _bias_factors(n: int, dln: float, bias: float, offset: float):
    j = np.arange(n, dtype=np.float64)
    j_c = (n - 1) / 2.0
    return np.exp(-bias * (j - j_c) * dln), np.exp(
        -bias * ((j - j_c) * dln + offset))


def fht(a, dln: float, mu: float, offset: float = 0.0,
        bias: float = 0.0) -> jax.Array:
    """Fast Hankel transform of order mu over a log-spaced grid with
    spacing dln (scipy.fft.fht).  offset = ln(k_c r_c); bias = the
    power-law bias q of the FFTLog variant."""
    a = put(a)
    if not jnp.issubdtype(a.dtype, jnp.floating):
        a = a.astype(default_float())
    n = a.shape[-1]
    u = _fhtcoeff(n, float(dln), float(mu), offset, bias, inverse=False)
    if bias != 0:
        pre, post = _bias_factors(n, float(dln), float(bias), float(offset))
        a = a * jnp.asarray(pre, a.dtype)
    A = irfft(rfft(a) * put(u), n)[..., ::-1]
    if bias != 0:
        A = A * jnp.asarray(post, A.dtype)
    return A


def ifht(A, dln: float, mu: float, offset: float = 0.0,
         bias: float = 0.0) -> jax.Array:
    """Inverse fast Hankel transform (scipy.fft.ifht)."""
    A = put(A)
    if not jnp.issubdtype(A.dtype, jnp.floating):
        A = A.astype(default_float())
    n = A.shape[-1]
    u = _fhtcoeff(n, float(dln), float(mu), offset, bias, inverse=True)
    if bias != 0:
        pre, post = _bias_factors(n, float(dln), float(bias), float(offset))
        A = A / jnp.asarray(post, A.dtype)
    a = irfft(rfft(A) / put(np.conj(u)), n)[..., ::-1]
    if bias != 0:
        a = a / jnp.asarray(pre, a.dtype)
    return a


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Shift `initial` to the nearest low-ringing offset
    (scipy.fft.fhtoffset; Hamilton 2000's periodicity condition on the
    Nyquist-mode phase)."""
    lnkr, q = float(initial), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2.0 * float(dln))
    zp = _loggamma(np.asarray(xp_ + 1j * y))
    zm = _loggamma(np.asarray(xm + 1j * y))
    arg = (np.log(2.0) - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)
