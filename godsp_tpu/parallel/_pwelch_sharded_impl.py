"""Distributed Welch PSD: time-axis (sequence-parallel) sharding.

The multi-device scaling of spectral.Pwelch's serial segment loop
(reference pwelch.go:107-122), per SURVEY.md §2.2/§5:

  * the signal's time axis is sharded over the mesh's "sp" axis;
  * segments that straddle a shard boundary need the next `noverlap`
    samples from the RIGHT neighbor — a ring halo exchange via
    jax.lax.ppermute (DSP's analogue of ring attention's neighbor
    passing);
  * each shard reduces its segments to a partial periodogram sum and a
    segment count; one psum over "sp" combines them.  The sum of
    periodograms is associative, so the sharded result equals the
    single-device result up to fp reordering.

Segment geometry matches spectral.Segment exactly ((len-size)/stride+1,
spectral.go:26-33): candidate starts beyond the global tail are masked
out on the last shard, reproducing the reference's discarded remainder
globally rather than per shard (SURVEY.md §7 hard part #3).

The same jitted step serves the one-shot API here and the streaming
driver (parallel.streaming): streaming chunks pass the head of the NEXT
chunk as `tail_halo` so boundary-straddling segments are exact.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from godsp_tpu import window as win
from godsp_tpu._dtypes import as_real_array
from godsp_tpu.dsputils.utils import zero_pad
from godsp_tpu.fft.core import fft_real
from godsp_tpu.spectral._pwelch_impl import PwelchOptions
from godsp_tpu.spectral._segment_impl import num_segments

__all__ = ["pwelch_sharded", "partial_periodogram", "sharded_partial_step", "resolve_geometry"]


def partial_periodogram(frames, w_pad, mask, pad: int, lp: int):
    """(masked periodogram sum over segments, masked count).

    frames: (..., nsegs, nfft) real; mask: (..., nsegs) 0/1 validity.
    One-sided interior-bin doubling and |FFT|^2 as in pwelch.go:111-121;
    normalization happens after the global reduction.
    """
    padded = zero_pad(frames, pad)
    spec = fft_real(padded * w_pad)[..., :lp]
    p = spec.real * spec.real + spec.imag * spec.imag
    p = jnp.sum(p * mask[..., None], axis=-2)
    doubler = jnp.ones(lp, dtype=p.dtype).at[1 : lp - 1].set(2.0)
    return p * doubler, jnp.sum(mask, axis=-1)


def _frames_from_block(block, halo, nfft: int, stride: int, segs_per_shard: int):
    """Frame a shard's (..., B) block extended by its (..., H) right halo."""
    ext = jnp.concatenate([block, halo], axis=-1)
    idx = jnp.arange(segs_per_shard)[:, None] * stride + jnp.arange(nfft)[None, :]
    return jnp.take(ext, idx, axis=-1)


@partial(
    jax.jit,
    static_argnames=("mesh", "nfft", "pad", "stride", "segs_per_shard", "lp"),
)
def sharded_partial_step(
    x,
    tail_halo,
    w_pad,
    mesh: Mesh,
    nfft: int,
    pad: int,
    stride: int,
    segs_per_shard: int,
    lp: int,
    total_segs,
):
    """One sharded accumulation step.

    x: (..., L) with L = n_sp * segs_per_shard * stride, time axis sharded
    over "sp"; a leading batch axis is sharded over "dp" when the mesh has
    one.  tail_halo: (..., H) samples that follow x in the global stream
    (zeros for one-shot use — the global-tail mask makes them irrelevant).
    pad here is the FFT/window length, i.e. max(options.pad, nfft); lp may
    be smaller than pad//2 + 1 when options.pad < nfft (head bins kept).
    total_segs is TRACED (not static): the streaming driver's final
    remainder chunk changes it per call, and a static arg would trigger a
    recompile at finalize.
    Returns (periodogram_sum, segment_count), psum-reduced over "sp" and
    replicated.
    """
    n_sp = mesh.shape["sp"]
    H = max(nfft - stride, 0)

    def shard_fn(x_local, tail_local):
        if H > 0:
            # Ring halo: src i -> dst i-1, so device i receives the head
            # of device i+1's block.  The wraparound into the last shard
            # is replaced by the streaming tail (or masked dead in
            # one-shot mode).
            halo = jax.lax.ppermute(
                x_local[..., :H],
                "sp",
                perm=[(i, (i - 1) % n_sp) for i in range(n_sp)],
            )
            sp_idx = jax.lax.axis_index("sp")
            is_last = (sp_idx == n_sp - 1)
            halo = jnp.where(is_last, tail_local, halo)
        else:
            halo = x_local[..., :0]

        # Global validity: segment s exists iff s*stride + nfft <= L_total,
        # i.e. s < total_segs (spectral.go:26-33).
        sp_idx = jax.lax.axis_index("sp")
        seg_global = sp_idx * segs_per_shard + jnp.arange(segs_per_shard)
        mask = (seg_global < total_segs).astype(x_local.dtype)
        mask = jnp.broadcast_to(mask, x_local.shape[:-1] + (segs_per_shard,))

        frames = _frames_from_block(x_local, halo, nfft, stride, segs_per_shard)
        p_sum, count = partial_periodogram(frames, w_pad, mask, pad, lp)
        return jax.lax.psum(p_sum, "sp"), jax.lax.psum(count, "sp")

    batch_dims = x.ndim - 1
    if batch_dims == 0:
        lead = []
    else:
        dp = mesh.shape.get("dp", 1)
        lead = ["dp" if dp > 1 else None] + [None] * (batch_dims - 1)
    in_x = P(*lead, "sp")
    in_tail = P(*lead, None)  # tail halo is small; replicated along sp
    out = P(*lead)
    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(in_x, in_tail), out_specs=(out, out),
    )(x, tail_halo)


def resolve_geometry(options: Optional[PwelchOptions]):
    """(nfft, window_fn, pad, fft_len, noverlap, scaling, stride, lp).

    fft_len = max(pad, nfft): the actual FFT/window length — the
    reference's ZeroPadF(seg, pad) is a no-op when pad < nfft
    (dsputils.go:60-63), so the transform then runs at nfft and only the
    first lp = pad//2 + 1 bins are kept.
    """
    o = options or PwelchOptions()
    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    stride = nfft - noverlap
    if stride <= 0:
        raise ValueError("noverlap must be < nfft")
    return (nfft, wf, pad, max(pad, nfft), noverlap, enable_scaling, stride,
            pad // 2 + 1)


def pwelch_sharded(
    x,
    fs: float,
    options: Optional[PwelchOptions] = None,
    mesh: Optional[Mesh] = None,
) -> tuple[jax.Array, jax.Array]:
    """Welch PSD of x with the time axis sharded over mesh axis "sp".

    x: (..., L) real; a leading batch axis (if present and mesh.dp > 1)
    is sharded over "dp".  Returns (Pxx, freqs) equal (within fp
    reordering) to spectral.pwelch.

    L must be divisible by n_sp * stride (SPMD uniformity); the streaming
    driver (parallel.streaming) handles arbitrary lengths.
    """
    from godsp_tpu.parallel.mesh import make_mesh

    x = as_real_array(x)
    if mesh is None:
        mesh = make_mesh()
    n_sp = mesh.shape["sp"]

    (nfft, wf, pad, fft_len, noverlap, enable_scaling, stride,
     lp) = resolve_geometry(options)
    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99
    L = x.shape[-1]
    if L % (n_sp * stride) != 0:
        raise ValueError(
            f"signal length {L} must be divisible by n_sp*stride = {n_sp * stride}; "
            "use parallel.streaming for arbitrary lengths"
        )
    segs_per_shard = L // (n_sp * stride)
    if max(nfft - stride, 0) > segs_per_shard * stride:
        raise ValueError(
            f"per-shard block ({segs_per_shard * stride} samples) must hold the "
            f"{nfft - stride}-sample overlap halo; use fewer sp shards or a longer signal"
        )
    total_segs = num_segments(L, nfft, noverlap)

    fdt = x.dtype
    w_fft = win.window_table(wf, fft_len).astype(fdt)
    w_nfft = win.window_table(wf, nfft).astype(fdt)
    w_norm = jnp.sum(w_nfft * w_nfft)
    if enable_scaling:
        w_norm = w_norm * jnp.asarray(fs, dtype=fdt)

    H = max(nfft - stride, 0)
    tail = jnp.zeros(x.shape[:-1] + (H,), dtype=fdt)
    p_sum, count = sharded_partial_step(
        x, tail, w_fft, mesh, nfft, fft_len, stride, segs_per_shard, lp,
        total_segs,
    )
    pxx = p_sum / (count[..., None] * w_norm)
    freqs = jnp.arange(lp, dtype=fdt) * (fs / pad)
    return pxx, freqs
