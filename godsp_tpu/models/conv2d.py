"""2-D convolution / correlation and image-style filtering.

The reference's only 2-D transform surface is the FFT2 driver
(fft.go:104-154); production DSP needs 2-D LINEAR convolution.  Both
operands zero-pad to powers of two and run ONE separable convolution
chain (fft/pow2.py pow2_convolve2) — the 2-D analogue of
models.filter.fftconvolve, so the hot path is batched FFTs.

scipy.signal semantics: convolve2d/correlate2d (mode full/same/valid,
boundary fill/wrap/symm), wiener (local-statistics adaptive filter),
hilbert2 (2-D analytic signal).  Leading batch axes are a framework
extension (scipy is strictly 2-D).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_complex_array, put
from godsp_tpu.dsputils.utils import next_power_of_2
from godsp_tpu.fft.pow2 import pow2_convolve2

__all__ = ["convolve2d", "correlate2d", "hilbert2", "medfilt2d", "order_filter", "sepfir2d", "wiener"]

_BOUNDARY_PAD = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


@partial(jax.jit, static_argnames=("mode", "real_out", "flip"))
def _conv2_full_jit(a, b, mode: str, real_out: bool, flip: bool):
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    n1 = next_power_of_2(s1 + k1 - 1)
    n2 = next_power_of_2(s2 + k2 - 1)
    pad_a = [(0, 0)] * (a.ndim - 2) + [(0, n1 - s1), (0, n2 - s2)]
    pad_b = [(0, 0)] * (b.ndim - 2) + [(0, n1 - k1), (0, n2 - k2)]
    ac = jnp.pad(as_complex_array(a), pad_a)
    bc = jnp.pad(as_complex_array(b), pad_b)
    full = pow2_convolve2(ac, bc, scale=1.0 / (n1 * n2))
    full = full[..., : s1 + k1 - 1, : s2 + k2 - 1]
    if mode == "same":
        # correlation's 'same' window is the mirror of convolution's
        # (kernel flip mirrors the centering remainder for even sizes)
        r0 = k1 // 2 if flip else (k1 - 1) // 2
        c0 = k2 // 2 if flip else (k2 - 1) // 2
        full = full[..., r0 : r0 + s1, c0 : c0 + s2]
    elif mode == "valid":
        full = full[..., k1 - 1 : s1, k2 - 1 : s2]
    return jnp.real(full) if real_out else full


@partial(jax.jit,
         static_argnames=("mode", "real_out", "flip", "pad_mode", "fill"))
def _conv2_boundary_jit(a, b, mode: str, real_out: bool, flip: bool,
                        pad_mode: str, fill):
    """Boundary-extended convolution as ONE program: pad, full
    convolution of the padded problem, cut back to the original full
    window, then the mode crop."""
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    padw = [(0, 0)] * (a.ndim - 2) + [(k1 - 1, k1 - 1), (k2 - 1, k2 - 1)]
    kw = {"constant_values": fill} if pad_mode == "constant" else {}
    a_p = jnp.pad(a, padw, mode=pad_mode, **kw)
    full_p = _conv2_full_jit(a_p, b, "full", real_out, flip)
    full = full_p[..., k1 - 1 : k1 - 1 + s1 + k1 - 1,
                  k2 - 1 : k2 - 1 + s2 + k2 - 1]
    if mode == "same":
        r0 = k1 // 2 if flip else (k1 - 1) // 2
        c0 = k2 // 2 if flip else (k2 - 1) // 2
        return full[..., r0 : r0 + s1, c0 : c0 + s2]
    if mode == "valid":
        return full[..., k1 - 1 : s1, k2 - 1 : s2]
    return full


def _conv2(in1, in2, mode: str, boundary: str, fillvalue, flip: bool):
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    if boundary not in _BOUNDARY_PAD:
        raise ValueError("boundary must be 'fill', 'wrap', or 'symm'")
    a = put(in1)
    b = put(in2)
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError("inputs must be at least 2-D")
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    if min(s1, s2, k1, k2) == 0:
        raise ValueError("empty input")
    if mode == "valid" and (s1 < k1 or s2 < k2):
        raise ValueError("valid mode needs in1 at least as large as in2 "
                         "in every dimension")
    if flip:
        b = b[..., ::-1, ::-1]
        if b.dtype.kind == "c":
            b = jnp.conj(b)
    fv = np.asarray(fillvalue)
    if fv.size != 1:
        raise ValueError("fillvalue must be a scalar")
    real_out = a.dtype.kind != "c" and b.dtype.kind != "c"
    if boundary != "fill" or bool(fv.ravel()[0] != 0):
        f0 = fv.ravel()[0]
        fill = (complex(f0) if a.dtype.kind == "c" else float(f0.real)) \
            if boundary == "fill" else 0.0
        return _conv2_boundary_jit(a, b, mode, real_out, flip,
                                   _BOUNDARY_PAD[boundary], fill)
    return _conv2_full_jit(a, b, mode, real_out, flip)


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0) -> jax.Array:
    """2-D linear convolution (scipy.signal.convolve2d semantics):
    mode 'full'/'same'/'valid'; boundary 'fill' (pad with fillvalue),
    'wrap' (circular), or 'symm' (symmetric reflection).  One separable
    digit-order FFT convolution chain; leading axes batch."""
    return _conv2(in1, in2, mode, boundary, fillvalue, flip=False)


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0) -> jax.Array:
    """2-D cross-correlation (scipy.signal.correlate2d): convolution with
    the doubly-reversed conjugate kernel, same mode/boundary rules."""
    return _conv2(in1, in2, mode, boundary, fillvalue, flip=True)


def wiener(im, mysize=None, noise=None) -> jax.Array:
    """Local-statistics Wiener filter (scipy.signal.wiener, 1-D or 2-D):
    pixelwise  lMean + max(lVar - noise, 0)/max(lVar, noise) * (im - lMean)
    with lMean/lVar the boxcar local moments and noise defaulting to the
    mean local variance.  The two box sums are the same ones-kernel
    convolution — one fused chain each."""
    im = put(im)
    if not jnp.issubdtype(im.dtype, jnp.inexact):
        from godsp_tpu._dtypes import default_float

        im = im.astype(default_float())
    nd = im.ndim
    if nd not in (1, 2):
        raise ValueError("wiener supports 1-D or 2-D input")
    if mysize is None:
        mysize = (3,) * nd
    if isinstance(mysize, int):
        mysize = (mysize,) * nd
    mysize = tuple(int(m) for m in mysize)
    if len(mysize) != nd or any(m < 1 or m % 2 == 0 for m in mysize):
        raise ValueError("mysize must give one odd size per dimension")
    size = 1.0
    for m in mysize:
        size *= m
    ones = jnp.ones(mysize, im.real.dtype)
    if nd == 1:
        from godsp_tpu.models.filter import fftconvolve

        conv = lambda x: fftconvolve(x, ones, mode="same")
    else:
        conv = lambda x: convolve2d(x, ones, mode="same")
    l_mean = conv(im) / size
    l_var = conv(im * im) / size - l_mean * l_mean
    l_var = jnp.maximum(l_var.real, 0.0) if im.dtype.kind == "c" else jnp.maximum(l_var, 0.0)
    if noise is None:
        noise = jnp.mean(l_var)
    res = l_mean + (im - l_mean) * (1.0 - noise / jnp.maximum(l_var, noise))
    return jnp.where(l_var < noise, l_mean, res)


def hilbert2(x) -> jax.Array:
    """2-D analytic signal (scipy.signal.hilbert2): keep only the (+,+)
    frequency quadrant via the separable step weighting u(k1)u(k2)
    (DC weight 1, strictly positive bins 2, negative bins and — by
    scipy's convention — the even-length Nyquist bin 0), then invert.
    Uses the framework's exact-length fft2/ifft2 (zero-extension would
    change the transform); any size works, powers of two are fastest."""
    x = put(x)
    if x.ndim != 2:
        raise ValueError("hilbert2 requires a 2-D input")
    if x.dtype.kind == "c":
        raise ValueError("hilbert2 requires real input")
    from godsp_tpu.fft.core import fft2, ifft2

    X = fft2(x)

    def step(n):
        # scipy's 2-D convention: u[0]=1, u[1:(n+1)//2]=2, rest 0 — the
        # Nyquist bin is DROPPED for even n (unlike 1-D hilbert)
        u = jnp.zeros(n, X.real.dtype)
        u = u.at[0].set(1.0)
        u = u.at[1 : (n + 1) // 2].set(2.0)
        return u

    n1, n2 = x.shape
    mask = step(n1)[:, None] * step(n2)[None, :]
    return ifft2(X * mask)


def sepfir2d(input, hrow, hcol) -> jax.Array:
    """Separable 2-D FIR filtering with mirror-symmetric boundary
    (scipy.signal.sepfir2d — edge-repeating symmetric extension):
    convolve rows with hrow and columns with hcol, both odd-length,
    output the same shape as the input.  Runs as symmetric-pad + one
    2-D convolution of the separable (outer-product) kernel through the
    digit-order chain."""
    x = put(input)
    hrow = put(hrow)
    hcol = put(hcol)
    if x.ndim != 2 or hrow.ndim != 1 or hcol.ndim != 1:
        raise ValueError("input must be 2-D and filters 1-D")
    kr, kc = hrow.shape[0], hcol.shape[0]
    if kr % 2 == 0 or kc % 2 == 0:
        raise ValueError("hrow and hcol must be odd length")
    # mirror-symmetric extension, then 'valid' convolution back to shape
    pr, pc = kc // 2, kr // 2  # hcol runs down columns, hrow along rows
    xp = jnp.pad(x, [(pr, pr), (pc, pc)], mode="symmetric") if (pr or pc) else x
    kern = hcol[:, None] * hrow[None, :]
    return _conv2_full_jit(xp, kern, "valid", x.dtype.kind != "c", False)


def order_filter(a, domain, rank: int) -> jax.Array:
    """2-D order (rank) filter (scipy.signal.order_filter): at each
    pixel, sort the neighbors selected by the nonzero entries of
    `domain` (odd sizes, zero-padded boundary) and keep the given rank."""
    a = put(a)
    dom = np.asarray(domain)
    if a.ndim != 2 or dom.ndim != 2:
        raise ValueError("input and domain must be 2-D")
    k1, k2 = dom.shape
    if k1 % 2 == 0 or k2 % 2 == 0:
        raise ValueError("domain sizes must be odd")
    sel = np.argwhere(dom != 0)
    if not 0 <= rank < len(sel):
        raise ValueError("rank must lie in [0, number of domain elements)")
    p1, p2 = k1 // 2, k2 // 2
    xp = jnp.pad(a, [(p1, p1), (p2, p2)])
    offs = tuple((int(i), int(j)) for i, j in sel)
    stack = jnp.stack(
        [xp[i : i + a.shape[0], j : j + a.shape[1]] for i, j in offs], axis=0)
    return jnp.sort(stack, axis=0)[int(rank)]


def medfilt2d(input, kernel_size=3) -> jax.Array:
    """2-D median filter with zero-padded boundary
    (scipy.signal.medfilt2d)."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    k1, k2 = int(kernel_size[0]), int(kernel_size[1])
    dom = np.ones((k1, k2))
    return order_filter(input, dom, (k1 * k2) // 2)
