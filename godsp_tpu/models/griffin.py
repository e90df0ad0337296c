"""Griffin-Lim phase reconstruction from a magnitude spectrogram.

The reference library has no synthesis path at all (spectral/pwelch.go
stops at PSD); this is the natural model-family capstone above
models.stft: recover a time signal whose STFT magnitude matches a
target, by alternating projections between the set of consistent
spectrograms (STFT of some signal) and the set with the given magnitude
[Griffin & Lim 1984], with the momentum acceleration of Perraudin,
Balazs & Sondergaard 2013 ("fast GLA").

The whole iteration is ONE jitted lax.fori_loop whose body is the
stft/istft analysis and synthesis bodies of models._stft_impl.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from godsp_tpu._dtypes import as_real_array, default_float
from godsp_tpu.models._stft_impl import (
    WindowSpec,
    _nola_norm,
    _ola_unnorm,
    _resolve_window,
    _stft_jit,
)

__all__ = ["griffin_lim"]


@partial(
    jax.jit,
    static_argnames=("nfft", "hop", "pad", "length", "n_iter", "momentum"),
)
def _gl_jit(mag, w, nfft: int, hop: int, pad: int, length: int, n_iter: int,
            momentum: float):
    fdt = default_float()
    cdt = jnp.complex128 if fdt == jnp.float64 else jnp.complex64
    n_frames = mag.shape[-2]
    span = (n_frames - 1) * hop + nfft
    mag = mag.astype(fdt)
    tiny = jnp.asarray(jnp.finfo(fdt).tiny, fdt)

    def fwd(y):
        return _stft_jit(y, w.astype(fdt), nfft, hop, pad, True)

    # The NOLA denominator is loop-invariant (only w/n_frames/hop):
    # hoist the scatter-add out of the fori_loop and divide in the body.
    norm = _nola_norm(w, n_frames, hop, span, fdt)

    def inv(s):
        return _ola_unnorm(s, w, nfft, hop, pad, True) / norm

    def project(c):
        """Replace c's magnitude with the target, keep its phase."""
        r = jnp.sqrt(c.real * c.real + c.imag * c.imag)
        return (mag / jnp.maximum(r, tiny)).astype(cdt) * c

    def body(_, carry):
        s, prev = carry
        r = fwd(inv(s)).astype(cdt)
        # Fast GLA: extrapolate along the consistency step before the
        # magnitude projection (momentum = 0 recovers classic GL).
        c = r + momentum * (r - prev) if momentum else r
        return project(c), r

    s0 = mag.astype(cdt)  # zero-phase init
    s, _ = jax.lax.fori_loop(
        0, n_iter, body, (s0, jnp.zeros_like(s0)), unroll=False
    )
    y = inv(s)
    if length > span:
        y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, length - span)])
    return y[..., :length]


def griffin_lim(
    mag,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
) -> jax.Array:
    """Signal whose STFT magnitude approximates `mag`.

    mag: (..., n_frames, pad//2 + 1) non-negative one-sided magnitudes
    (e.g. models.spectrogram(..., scale="magnitude")), batched over
    leading axes.  nfft/hop/window/pad must match the analysis that
    produced it (defaults as models.stft: hop = nfft//2, Hann,
    pad = nfft).  momentum in [0, 1) is the fast-GLA extrapolation
    (0 = classic Griffin-Lim); n_iter alternating projections run as one
    compiled loop.  Returns (..., length) real, length defaulting to the
    covered span (n_frames - 1)*hop + nfft.
    """
    mag = as_real_array(mag)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    if pad < nfft:
        raise ValueError("pad must be >= nfft")
    if mag.ndim < 2:
        raise ValueError("mag must be (..., n_frames, bins)")
    bins = mag.shape[-1]
    if pad // 2 + 1 != bins:
        raise ValueError(
            f"pad={pad} inconsistent with {bins} one-sided bins "
            f"(need pad//2 + 1 == bins)"
        )
    if not 0.0 <= momentum < 1.0:
        raise ValueError("momentum must be in [0, 1)")
    if n_iter < 0:
        raise ValueError("n_iter must be >= 0")
    n_frames = mag.shape[-2]
    if n_frames == 0:
        raise ValueError("mag has no frames")
    length = length or (n_frames - 1) * hop + nfft
    w = _resolve_window(window, nfft, default_float())
    return _gl_jit(mag, w, nfft, hop, pad, length, n_iter, float(momentum))
