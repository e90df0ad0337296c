"""Tensor-parallel FFT: one giant transform split across the mesh.

SURVEY.md §2.2 lists this as the TP row of the parallelism map: a single
N-point DFT factored N = p x N2 (p = number of "sp" shards) so each
device computes local batched FFTs while the cross-device data movement
rides collectives (NCCL over NVLink on GPUs):

  X[i1, i2] = x[N2*i1 + i2]  (i1 = shard row, i2 local)
  step 1:    A[k1, i2] = sum_i1 F1[k1, i1] X[i1, i2]
             - even path (N2 % p == 0): all_to_all block transpose so
               each device holds all i1 for an i2-slice, then a local
               p x p matmul, then all_to_all back (minimal traffic:
               2 * N/p elements per device);
             - uneven path (any N % p == 0): each device forms its
               F1-column outer product F1[:, i1] * X[i1, :] and ONE
               psum_scatter hands device k1 its reduced row directly
               (reduce-scatter traffic, no divisibility demands).
  step 2:    B = A * W_N^{k1 i2}  (exact trace-time f64 twiddle split)
  step 3:    Y[k1, k2] = FFT_{N2}(B[k1, :])[k2]  (local batched FFT)
  output:    Y[k1 + p*k2] — "digit" shard order; order="natural"
             performs one more all_to_all block transpose.

Batched: leading axes are carried along locally (replicated over "sp" —
the TP semantic shards the SIGNAL axis).  The shard_map runs with
check_vma=True (collective correctness checking).  The p-point DFT of
step 1 runs at Precision.HIGHEST: at the default precision a GPU would
contract it in TF32.

Everything local reuses the framework's batched FFT stack.  Validated against numpy on the 8-device virtual mesh
(tests/test_parallel.py).  Reference analogue: the worker-pool scaling
intent of SetWorkerPoolSize (fft/fft.go:89-101), re-expressed as
chip-level parallelism.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from godsp_tpu._dtypes import as_complex_array, complex_for, put
from godsp_tpu.dsputils.utils import is_power_of_2

__all__ = ["fft_sharded"]

_HI = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _f1_twiddle(p: int, n2_local: int, n2: int, inverse: bool):
    """(F1[p, p], per-shard twiddle builder inputs) as float64 numpy."""
    k1 = np.arange(p, dtype=np.float64)
    f1 = np.exp(-2j * np.pi * np.outer(k1, k1) / p)
    if inverse:
        f1 = np.conj(f1)
    return f1


@lru_cache(maxsize=None)
def _twiddle_tables(p: int, n2: int, inverse: bool):
    """Trace-time f64 split of the step-2 twiddle W_N^{k1 * i2}.

    i2 = q*m + t for any block size m dividing n2 gives
    W^{k1 i2} = W^{k1 q m} * W^{k1 t}; with m = n2 (whole-shard rows,
    the uneven path) or m = n2 // p (all_to_all slices) this splits into
      row[s, k1] = W_N^{k1 * s * m}   (runtime-indexed by shard id)
      col[k1, t] = W_N^{k1 * t}       (shared constant)
    — exact f64 numpy at trace time; nothing requests x64 on device.
    """
    n = p * n2
    m = n2 // p
    w = -2j * np.pi / n
    k1 = np.arange(p, dtype=np.float64)
    col = np.exp(w * np.outer(k1, np.arange(m, dtype=np.float64)))
    row = np.exp(w * np.outer(k1 * m, k1))  # [s, k1] = W^{k1 s m}
    if inverse:
        col, row = np.conj(col), np.conj(row)
    return col, row


@lru_cache(maxsize=None)
def _twiddle_full_row(p: int, n2: int, inverse: bool):
    """Uneven path: full per-row twiddle table T[k1, i2] = W_N^{k1 i2},
    exact f64 at trace time, indexed by shard id at runtime."""
    n = p * n2
    k1 = np.arange(p, dtype=np.float64)
    i2 = np.arange(n2, dtype=np.float64)
    t = np.exp(-2j * np.pi * np.outer(k1, i2) / n)
    return np.conj(t) if inverse else t


def fft_sharded(
    x,
    mesh: Mesh,
    inverse: bool = False,
    order: str = "natural",
) -> jax.Array:
    """DFT of the trailing axis of x, sharded over the mesh's "sp" axis.

    x: (..., N) complex/real with N % p == 0 and N/p a power of 2;
    leading axes are batched (replicated across shards).  Returns the
    unnormalized forward (or conjugated inverse) DFT, sharded the same
    way.  order="natural" returns standard bin order; order="digit"
    skips the final transpose and returns Y[k1 + p*k2] at position
    k1*N2 + k2 — free for consumers that reduce over bins or feed a
    matching inverse.

    The inverse here conjugates the tables and does NOT apply 1/N (match
    the public ifft convention by scaling externally).
    """
    if order not in ("natural", "digit"):
        raise ValueError(f"unknown order: {order}")
    x = as_complex_array(put(x))
    n = x.shape[-1]
    p = mesh.shape["sp"]
    if n % p != 0:
        raise ValueError(f"N={n} must be divisible by the shard count p={p}")
    n2 = n // p
    if not is_power_of_2(n2):
        raise ValueError(f"local length N/p={n2} must be a power of 2")
    lead = x.shape[:-1]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    cdtype = complex_for(x.dtype)
    even = n2 % p == 0
    out = _run_cached(mesh, p, n2, b, inverse, order, even, str(cdtype))(
        x.reshape(b, n)
    )
    return out.reshape(*lead, n)


@lru_cache(maxsize=None)
def _run_cached(
    mesh, p: int, n2: int, b: int, inverse: bool, order: str, even: bool,
    cdtype_name: str,
):
    """One jitted program per (mesh, geometry): rebuilding the jit per
    call would retrace every time, so everything (including the F1
    constant, which embeds at trace time) lives under this jit."""
    cdtype = jnp.dtype(cdtype_name)
    n = p * n2

    def shard_fn(xl):
        # xl: (b, 1, n2) — row i1 = my shard index, X[i1, i2] = x[n2*i1+i2].
        from godsp_tpu.fft.pow2 import pow2_fft

        f1 = jnp.asarray(_f1_twiddle(p, n2 // p, n2, inverse), dtype=cdtype)
        my = jax.lax.axis_index("sp")
        xl = xl.reshape(b, n2)

        if even:
            # T1: (b, p, n2/p) blocks -> all_to_all so this device holds
            # X[i1, my-th i2 slice] for ALL i1.
            blocks = xl.reshape(b, p, n2 // p)
            cols = jax.lax.all_to_all(blocks, "sp", split_axis=1, concat_axis=1)

            # Step 1: p-point DFT over i1 (local matmul over axis 1).
            a = jnp.einsum("ki,bin->bkn", f1, cols, precision=_HI)  # (b, p, n2/p)

            # Step 2: twiddle W_N^{k1 * i2} on this device's i2 slice,
            # from the exact trace-time f64 split (row indexed by shard).
            col, row = _twiddle_tables(p, n2, inverse)
            tw = (
                jnp.asarray(row, cdtype)[my][None, :, None]
                * jnp.asarray(col, cdtype)[None, :, :]
            )
            a = a * tw

            # T2: back to row layout — device k1 gets B[k1, :].
            rows = jax.lax.all_to_all(
                a, "sp", split_axis=1, concat_axis=1
            ).reshape(b, n2)
        else:
            # Uneven path (n2 % p != 0): each device forms its F1-column
            # outer product and one psum_scatter reduces AND distributes
            # row k1 to device k1 — reduce-scatter traffic, no
            # divisibility demands beyond N % p.
            contrib = jnp.einsum(
                "k,bn->kbn", f1[:, my], xl, precision=_HI
            )  # (p, b, n2)
            rows = jax.lax.psum_scatter(
                contrib, "sp", scatter_dimension=0, tiled=False
            )  # (b, n2): the my-th reduced row
            t_full = jnp.asarray(_twiddle_full_row(p, n2, inverse), cdtype)
            rows = rows * t_full[my][None, :]

        # Step 3: local N2-point FFT.
        y = pow2_fft(rows, inverse=inverse)  # (b, n2): Y[my + p*k2]

        if order == "digit":
            return y.reshape(b, 1, n2)

        # Natural order: global transpose of the (p, n2) digit layout.
        # Device k1 holds Y[k1 + p*k2] for all k2; natural position of
        # bin (k1, k2) is k1 + p*k2.
        if even:
            # One more all_to_all plus a local transpose.
            blk = y.reshape(b, p, n2 // p)
            got = jax.lax.all_to_all(blk, "sp", split_axis=1, concat_axis=1)
            nat = jnp.swapaxes(got, 1, 2).reshape(b, n2)
        else:
            # Uneven fallback: all_gather + a trace-time-constant local
            # gather of this shard's natural span (bins my*n2 .. +n2).
            gathered = jax.lax.all_gather(y, "sp")  # (p, b, n2)
            k = np.arange(n2, dtype=np.int64)  # local natural offsets
            gbin = k  # global bin = my*n2 + k, split below
            # my*n2 + k = k1 + p*k2: k1 = (my*n2 + k) % p, k2 = ... both
            # depend on my (traced), so build via modular arithmetic.
            myb = my * n2
            k1 = (myb + jnp.asarray(gbin)) % p
            k2 = (myb + jnp.asarray(gbin)) // p
            nat = gathered[k1, :, k2].swapaxes(0, 1)  # (b, n2)
        return nat.reshape(b, 1, n2)

    @jax.jit
    def run(xx):
        out = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=P(None, "sp"),
            out_specs=P(None, "sp"),
            check_vma=True,
        )(xx.reshape(b, p, n2))
        return out.reshape(b, n)

    return run
