"""Sequence-parallel STFT / spectrogram: time axis sharded over "sp".

Completes the SP story beyond PSD (parallel/pwelch_sharded.py): for
giant signals, frames are computed per shard with the left-neighbor
halo exchange so boundary-straddling frames are exact, and the OUTPUT
stays sharded over its frame axis — nothing is gathered.

Geometry matches models.stft exactly (n_frames = (L - nfft)//hop + 1
globally; the tail remainder is dropped globally, not per shard).
Requires L divisible by n_sp * hop, the per-shard block >= the
(nfft - hop) halo, and — like all shard_map code here — the same jitted
step runs on any mesh size including 1.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from godsp_tpu._dtypes import as_real_array, default_float, put
from godsp_tpu.fft.core import fft_real
from godsp_tpu.models._stft_impl import (
    WindowSpec,
    _ola_unnorm,
    _resolve_window,
    _settle_ola_block,
)

__all__ = ["istft_sharded", "spectrogram_sharded"]


@partial(
    jax.jit,
    static_argnames=("mesh", "nfft", "hop", "pad", "frames_per_shard", "total_frames"),
)
def _sharded_power_frames(
    x,
    w,
    mesh: Mesh,
    nfft: int,
    hop: int,
    pad: int,
    frames_per_shard: int,
    total_frames: int,
):
    """(..., n_sp * frames_per_shard, lp) power frames, frame axis sharded.

    Invalid tail frames (>= total_frames) are zeroed.
    """
    n_sp = mesh.shape["sp"]
    H = max(nfft - hop, 0)
    lp = pad // 2 + 1

    def shard_fn(x_local):
        if H > 0:
            halo = jax.lax.ppermute(
                x_local[..., :H], "sp",
                perm=[(i, (i - 1) % n_sp) for i in range(n_sp)],
            )
        else:
            halo = x_local[..., :0]
        ext = jnp.concatenate([x_local, halo], axis=-1)

        sp_idx = jax.lax.axis_index("sp")
        frame_global = sp_idx * frames_per_shard + jnp.arange(frames_per_shard)
        mask = (frame_global < total_frames).astype(ext.dtype)

        idx = (
            jnp.arange(frames_per_shard)[:, None] * hop
            + jnp.arange(nfft)[None, :]
        )
        frames = jnp.take(ext, idx, axis=-1) * w
        if pad > nfft:
            frames = jnp.pad(
                frames, [(0, 0)] * (frames.ndim - 1) + [(0, pad - nfft)]
            )
        spec = fft_real(frames)[..., :lp]
        p = spec.real * spec.real + spec.imag * spec.imag
        return p * mask[..., None]

    lead = x.ndim - 1
    in_spec = P(*([None] * lead), "sp")
    out_spec = P(*([None] * lead), "sp", None)
    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec
    )(x)


def spectrogram_sharded(
    x,
    mesh: Mesh,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
) -> jax.Array:
    """Power spectrogram of a long signal, frames sharded over "sp".

    Returns (..., total_frames, pad//2 + 1) — equal to
    models.spectrogram(x, ...) with the frame axis laid out across the
    mesh (padded invalid tail frames are sliced off).  L must divide by
    n_sp * hop; each shard's block must hold the (nfft - hop) halo.
    """
    x = as_real_array(x)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    n_sp = mesh.shape["sp"]
    L = x.shape[-1]
    if L % (n_sp * hop) != 0:
        raise ValueError(f"L={L} must divide by n_sp*hop={n_sp * hop}")
    frames_per_shard = L // (n_sp * hop)
    if max(nfft - hop, 0) > frames_per_shard * hop:
        raise ValueError(
            "per-shard block must hold the nfft-hop halo; use fewer shards"
        )
    total_frames = (L - nfft) // hop + 1

    w = _resolve_window(window, nfft, x.dtype)
    p = _sharded_power_frames(
        x, w, mesh, nfft, hop, pad, frames_per_shard, total_frames
    )
    return p[..., :total_frames, :]


@partial(
    jax.jit,
    static_argnames=("mesh", "nfft", "hop", "pad", "onesided", "fps"),
)
def _sharded_ola(spec, w, mesh: Mesh, nfft: int, hop: int, pad: int,
                 onesided: bool, fps: int):
    """Frame-sharded weighted overlap-add: (..., n_sp*fps, bins) spectra
    sharded over the frame axis -> (..., n_sp*fps*hop) time samples
    sharded over the time axis.

    Each shard overlap-adds its own frames, then sends the (nfft - hop)-sample tail
    that spills past its time block to the RIGHT neighbor with one
    ppermute — the synthesis twin of the analysis halo in
    _sharded_power_frames.  The NOLA denominator is assembled the same
    way (it is shard-invariant, so its "exchange" is a masked local
    add).  Shard 0's head receives nothing: there are no frames before
    the first, exactly as in the unsharded normalization.
    """
    n_sp = mesh.shape["sp"]
    H = nfft - hop
    fdt = default_float()
    own_len = fps * hop

    def shard_fn(spec_local):
        y = _ola_unnorm(spec_local, w, nfft, hop, pad, onesided)
        sp_idx = jax.lax.axis_index("sp")
        if H > 0:
            recv = jax.lax.ppermute(
                y[..., own_len:], "sp",
                perm=[(i, (i + 1) % n_sp) for i in range(n_sp)],
            )
        else:
            recv = y[..., own_len:]
        # gate=0 on shard 0: its head has no predecessor frames, so both
        # the (ring-wrapped) spill and the norm tail are masked — the
        # same boundary arithmetic as the streaming chunk driver.
        gate = jnp.where(sp_idx == 0, 0.0, 1.0).astype(fdt)
        return _settle_ola_block(
            y[..., :own_len], recv, gate, w, nfft, hop, fps
        )

    lead = spec.ndim - 2
    in_spec = P(*([None] * lead), "sp", None)
    out_spec = P(*([None] * lead), "sp")
    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec
    )(spec)


def istft_sharded(
    spec,
    mesh: Mesh,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    onesided: bool = True,
) -> jax.Array:
    """Inverse STFT of frame-sharded spectra; output time-sharded.

    spec: (..., n_frames, bins) complex with the frame axis laid out
    over the mesh's "sp" axis.  Returns (..., n_frames * hop) real —
    models.istft(spec, ...)[..., :n_frames*hop] with the time axis
    sharded over "sp"; the final (nfft - hop)-sample coda past
    n_frames*hop stays truncated so every shard owns an equal block
    (gather-free, as spectrogram_sharded).  Requires n_frames divisible
    by n_sp, hop <= nfft, and each shard's time block >= the
    (nfft - hop) spill: (n_frames/n_sp)*hop >= nfft - hop.
    """
    spec = put(spec)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    if hop > nfft:
        raise ValueError("istft_sharded requires hop <= nfft")
    bins = spec.shape[-1]
    if onesided:
        pad = pad if pad is not None else 2 * (bins - 1)
        if pad // 2 + 1 != bins:
            raise ValueError(
                f"pad={pad} inconsistent with {bins} one-sided bins"
            )
    else:
        if pad is not None and pad != bins:
            raise ValueError(f"pad={pad} != two-sided bin count {bins}")
        pad = bins
    n_sp = mesh.shape["sp"]
    n_frames = spec.shape[-2]
    if n_frames == 0 or n_frames % n_sp != 0:
        raise ValueError(
            f"n_frames={n_frames} must be a positive multiple of n_sp={n_sp}"
        )
    fps = n_frames // n_sp
    if nfft - hop > fps * hop:
        raise ValueError(
            "per-shard time block must hold the nfft-hop spill; "
            "use fewer shards"
        )
    w = _resolve_window(window, nfft, default_float())
    return _sharded_ola(spec, w, mesh, nfft, hop, pad, onesided, fps)
