"""utils.oracles: the float64 numpy references the on-chip smoke check
scores device results against."""

import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import spectral
from godsp_tpu.dsputils import snr_db
from godsp_tpu.utils.oracles import csd_np, pwelch_np, tone_signal, tone_snr_db


def test_pwelch_np_oracle_matches_framework():
    rng = np.random.default_rng(1)
    x = rng.normal(size=10000)
    ref = pwelch_np(x, 2.0, 256, 128)
    p, _ = spectral.pwelch(
        jnp.asarray(x), 2.0, spectral.PwelchOptions(nfft=256, noverlap=128)
    )
    assert snr_db(np.asarray(p), ref) > 120.0


@pytest.mark.parametrize("nfft,noverlap,pad", [(256, 0, 512), (512, 352, None),
                                               (1024, 512, 256)])
def test_pwelch_np_pad_and_hop(nfft, noverlap, pad):
    """pad > nfft (window at the pad length), the 10 ms hop, and the
    pad < nfft head-bins quirk (dsputils.go:60-63)."""
    rng = np.random.default_rng(nfft)
    x = rng.normal(size=20000)
    ref = pwelch_np(x, 8.0, nfft, noverlap, pad=pad)
    p, _ = spectral.pwelch(x, 8.0, spectral.PwelchOptions(
        nfft=nfft, noverlap=noverlap, pad=pad or 0))
    assert ref.shape == p.shape
    assert snr_db(np.asarray(p), ref) >= 200.0


def test_pwelch_np_blocks_and_rows():
    """Block-wise accumulation equals one block; leading axes batch."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 30000))
    whole = pwelch_np(x, 1.0, 256, 128)
    blocked = pwelch_np(x, 1.0, 256, 128, block_segs=7)
    np.testing.assert_allclose(blocked, whole, rtol=1e-12)
    for r in range(3):
        np.testing.assert_allclose(whole[r], pwelch_np(x[r], 1.0, 256, 128), rtol=1e-12)


def test_csd_np_auto_spectrum_is_pwelch_np():
    x = np.random.default_rng(3).normal(size=(2, 9000))
    c = csd_np(x, x, 4.0, 512, 352, pad=1024)
    np.testing.assert_allclose(c.imag, 0.0, atol=1e-12 * np.abs(c.real).max())
    np.testing.assert_allclose(c.real, pwelch_np(x, 4.0, 512, 352, pad=1024), rtol=1e-12)


def test_multi_tone_oracle_algebra():
    """The residual-form SNR (total energy minus tone bins plus tone-bin
    errors) equals a direct full-spectrum comparison."""
    N = 1 << 12
    tones = [(3, 0.5, 0.1), (123, 0.25, -0.3), ((N >> 1) + 7, 0.125, 0.7)]
    n_idx = np.arange(N)
    z = np.zeros(N, np.complex128)
    for f, a, ph in tones:
        z += a * np.exp(2j * np.pi * (((f * n_idx) % N) / N + ph))
    X = np.fft.fft(z)
    want = np.zeros(N, np.complex128)
    for f, a, ph in tones:
        want[f] = N * a * np.exp(2j * np.pi * ph)
    direct_err = float(np.sum(np.abs(X - want) ** 2))
    decomposed = (
        float(np.sum(np.abs(X) ** 2))
        - sum(float(np.abs(X[f]) ** 2) for f, _, _ in tones)
        + sum(
            float(np.abs(X[f] - N * a * np.exp(2j * np.pi * ph)) ** 2)
            for f, a, ph in tones
        )
    )
    assert np.isclose(direct_err, decomposed, rtol=1e-9)
    sig = sum((N * a) ** 2 for _, a, _ in tones)
    assert 10 * np.log10(sig / max(decomposed, 1e-300)) > 200.0  # f64 fft


def test_tone_helpers_closed_form():
    n = 1 << 12
    tones = [(3, 0.5, 0.1), (123, 0.25, -0.3), ((n >> 1) + 7, 0.125, 0.7)]
    X = np.fft.fft(tone_signal(n, tones))
    assert tone_snr_db(X, tones) > 200.0
    # A wrong amplitude on one tone is caught.
    X[123] *= 1.001
    assert tone_snr_db(X, tones) < 80.0
