"""Dtype policy for the DSP framework.

The reference library computes everything in float64/complex128 on CPU
(go-dsp dsputils/dsputils.go:25, fft/fft.go:25).  On a GPU, float64 runs
at a small fraction of the float32 rate, while float32/complex64 clears
the 120 dB SNR parity bound for the supported transform sizes (error ~
eps * sqrt(log2 N)).

Policy:
  * default real dtype   = float64 when jax_enable_x64 is on (CPU parity
    tests), float32 otherwise (the accelerator's fast path);
  * complex dtype follows the real dtype (complex128 / complex64);
  * every public function accepts any real/complex input and promotes it
    to the policy dtype, so user code is dtype-agnostic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "default_float",
    "default_complex",
    "complex_for",
    "real_for",
    "as_complex_array",
    "as_real_array",
    "put",
]


def default_float() -> jnp.dtype:
    """The framework-wide default real dtype (f64 under x64, else f32)."""
    return jnp.dtype(jnp.float64) if jax.config.jax_enable_x64 else jnp.dtype(jnp.float32)


def default_complex() -> jnp.dtype:
    """The framework-wide default complex dtype (c128 under x64, else c64)."""
    return jnp.dtype(jnp.complex128) if jax.config.jax_enable_x64 else jnp.dtype(jnp.complex64)


def complex_for(dtype) -> jnp.dtype:
    """Complex dtype matching the precision of a real (or complex) dtype."""
    dtype = jnp.dtype(dtype)
    if dtype.kind == "c":
        return dtype
    if dtype == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def real_for(dtype) -> jnp.dtype:
    """Real dtype matching the precision of a complex (or real) dtype."""
    dtype = jnp.dtype(dtype)
    if dtype.kind != "c":
        return dtype
    if dtype == jnp.complex128:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def as_complex_array(x) -> jax.Array:
    """Convert input to a complex jnp array at policy precision.

    Mirrors dsputils.ToComplex (reference dsputils/dsputils.go:25-31) as a
    dtype lift instead of an element loop.
    """
    x = jnp.asarray(x)
    if x.dtype.kind == "c":
        return x
    if x.dtype.kind != "f":  # ints/bools lift through the policy float
        x = x.astype(default_float())
    return x.astype(complex_for(x.dtype))


def as_real_array(x) -> jax.Array:
    """Convert input to a real jnp array at policy precision."""
    x = jnp.asarray(x)
    if x.dtype.kind == "c":
        raise ValueError("expected real input, got complex")
    if x.dtype.kind != "f":
        x = x.astype(default_float())
    return x


def put(x) -> jax.Array:
    """Move input to the default device: a plain jnp.asarray, kept as
    the one named entry point that every public function routes its
    inputs through (see also utils.to_host for the device->host
    direction).  Device arrays pass through unchanged."""
    return jnp.asarray(x)


def np_float() -> np.dtype:
    return np.dtype(np.float64) if jax.config.jax_enable_x64 else np.dtype(np.float32)


def np_complex() -> np.dtype:
    return np.dtype(np.complex128) if jax.config.jax_enable_x64 else np.dtype(np.complex64)
