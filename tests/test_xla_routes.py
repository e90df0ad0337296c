"""The single XLA route of every public transform and estimator, swept
over the geometries the framework serves, against float64 numpy/scipy
oracles (float64 on the CPU: SNR >= 200 dB unless noted).

Also pins two properties of the routes themselves: no public route
lowers to a pallas_call, and every matrix product in the repaired
contractions asks for Precision.HIGHEST (a GPU would otherwise contract
float32 in TF32).
"""

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import fft, models, spectral
from godsp_tpu import window as win
from godsp_tpu.dsputils import snr_db
from godsp_tpu.utils.oracles import csd_np, pwelch_np

RNG = np.random.default_rng


# ---------------------------------------------------------------------------
# Power-of-2 and real-input FFT sizes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 8192, 16384])
def test_pow2_fft_vs_numpy(n):
    rng = RNG(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    assert snr_db(np.asarray(fft.fft(x)), np.fft.fft(x, axis=-1)) >= 200.0


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 8192, 16384])
def test_pow2_ifft_round_trip(n):
    rng = RNG(n + 1)
    x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    back = np.asarray(fft.ifft(fft.fft(x)))
    assert snr_db(back, x) >= 200.0


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_rfft_split_vs_numpy(n):
    x = RNG(n).normal(size=(5, n))
    yr, yi = fft.rfft_split(x)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert got.shape == (5, n // 2 + 1)
    assert snr_db(got, np.fft.rfft(x, axis=-1)) >= 200.0


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_fft_real_vs_numpy(n):
    x = RNG(n + 2).normal(size=(4, n))
    assert snr_db(np.asarray(fft.fft_real(x)), np.fft.fft(x, axis=-1)) >= 200.0


def test_split_planes_round_trip_and_odd_length():
    rng = RNG(5)
    for n in (100, 1024):  # Bluestein and power of 2
        x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
        yr, yi = fft.fft_split(x.real, x.imag)
        assert snr_db(np.asarray(yr) + 1j * np.asarray(yi), np.fft.fft(x)) >= 200.0
        zr, zi = fft.ifft_split(yr, yi)
        assert snr_db(np.asarray(zr) + 1j * np.asarray(zi), x) >= 200.0


def test_pow2_convolve_chains():
    from godsp_tpu.fft import pow2

    rng = RNG(31)
    n = 1024
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    y = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = np.asarray(pow2.pow2_convolve(jnp.asarray(x), jnp.asarray(y), scale=1.0 / n))
    assert snr_db(got, np.fft.ifft(np.fft.fft(x) * np.fft.fft(y))) >= 200.0
    h = np.fft.fft(y)
    got = np.asarray(pow2.pow2_circular_filter(jnp.asarray(x), jnp.asarray(h), 1.0 / n))
    assert snr_db(got, np.fft.ifft(np.fft.fft(x) * h)) >= 200.0


def test_pow2_convolve2_vs_numpy():
    from godsp_tpu.fft import pow2

    rng = RNG(37)
    n1, n2 = 256, 512
    x = rng.normal(size=(n1, n2)) + 1j * rng.normal(size=(n1, n2))
    y = rng.normal(size=(n1, n2)) + 1j * rng.normal(size=(n1, n2))
    got = np.asarray(pow2.pow2_convolve2(jnp.asarray(x), jnp.asarray(y),
                                         scale=1.0 / (n1 * n2)))
    assert snr_db(got, np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(y))) >= 200.0


# ---------------------------------------------------------------------------
# Welch geometries: (nfft, pad, stride) — lane-aligned and phase-class
# hops (160/320/480, 48), partial periods, pad > nfft, pad < nfft, odd
# strides, and non-power-of-2 frames.
# ---------------------------------------------------------------------------

WELCH_GEOMETRIES = [
    (256, 256, 256), (256, 256, 128), (1024, 1024, 512), (512, 512, 128),
    (256, 512, 128), (1024, 1024, 256), (1024, 1024, 128), (1024, 1024, 384),
    (1024, 1024, 160), (1024, 1024, 320), (256, 256, 48), (1024, 2048, 160),
    (512, 512, 320), (256, 512, 48), (1024, 1024, 480), (512, 512, 160),
    (1024, 512, 512), (256, 256, 156), (1024, 1024, 100), (256, 256, 7),
    (384, 512, 128), (100, 100, 100), (400, 512, 160),
]


@pytest.mark.parametrize("nfft,pad,stride", WELCH_GEOMETRIES)
def test_pwelch_geometry_vs_oracle(nfft, pad, stride):
    rng = RNG(nfft * 7 + pad + stride)
    segs = 21
    x = rng.normal(size=(segs - 1) * stride + nfft + int(rng.integers(0, stride)))
    opts = spectral.PwelchOptions(nfft=nfft, pad=pad, noverlap=nfft - stride)
    p, f = spectral.pwelch(x, 2.0, opts)
    ref = pwelch_np(x, 2.0, nfft, nfft - stride, pad=pad)
    assert p.shape == ref.shape == (pad // 2 + 1,)
    assert snr_db(np.asarray(p), ref) >= 200.0
    np.testing.assert_allclose(np.asarray(f), np.arange(pad // 2 + 1) * 2.0 / pad)


@pytest.mark.parametrize("seed", range(8))
def test_pwelch_random_geometry(seed):
    """Seeded random (nfft, pad, stride, segs, ragged tail) sweep."""
    rng = RNG(2026 + seed)
    nfft = int(rng.choice([128, 256, 384, 512, 1000, 1024]))
    pad = int(nfft * rng.choice([1, 2]))
    stride = int(rng.integers(1, nfft + 1))
    segs = int(rng.integers(1, 30))
    x = rng.normal(size=(segs - 1) * stride + nfft + int(rng.integers(0, stride)))
    opts = spectral.PwelchOptions(nfft=nfft, pad=pad, noverlap=nfft - stride)
    p, _ = spectral.pwelch(x, 1.0, opts)
    ref = pwelch_np(x, 1.0, nfft, nfft - stride, pad=pad)
    assert snr_db(np.asarray(p), ref) >= 200.0, (nfft, pad, stride, segs)


def test_pwelch_batched_rows_hamming():
    rng = RNG(9)
    x = rng.normal(size=(3, 256 * 5))
    opts = spectral.PwelchOptions(nfft=256, window="hamming")
    p, _ = spectral.pwelch(x, 1.0, opts)
    assert p.shape == (3, 129)
    ref = pwelch_np(x, 1.0, 256, 0, wname="hamming")
    assert snr_db(np.asarray(p), ref) >= 200.0


def test_pwelch_from_frames_equals_pwelch():
    rng = RNG(50)
    x = rng.normal(size=10_000)
    opts = spectral.PwelchOptions(nfft=256, noverlap=100)
    frames = spectral.segment(jnp.asarray(x), 256, 100)
    a, _ = spectral.pwelch_from_frames(frames, 2.0, opts)
    b, _ = spectral.pwelch(x, 2.0, opts)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


# ---------------------------------------------------------------------------
# Cross spectra and the scipy-convention estimators.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nfft,pad,stride", [(256, 256, 128), (256, 256, 156),
                                             (1024, 1024, 512), (256, 512, 128)])
def test_csd_geometry_vs_oracle(nfft, pad, stride):
    rng = RNG(60 + stride)
    L = 20 * stride + nfft
    x = rng.normal(size=L)
    y = 0.5 * np.roll(x, 7) + 0.5 * rng.normal(size=L)
    opts = spectral.PwelchOptions(nfft=nfft, pad=pad, noverlap=nfft - stride)
    got, _ = spectral.csd(x, y, 2.0, opts)
    ref = csd_np(x, y, 2.0, nfft, nfft - stride, pad=pad)
    assert snr_db(np.asarray(got), ref) >= 200.0


@pytest.mark.parametrize("geom", [(1024, 512, 1024), (256, 128, 256), (512, 0, 1024)])
def test_scipy_welch_geometry(geom):
    ss = pytest.importorskip("scipy.signal")
    nperseg, nover, nfft = geom
    x = RNG(0).normal(size=8192)
    _, got = spectral.welch(x, 2.0, window="hann", nperseg=nperseg,
                            noverlap=nover, nfft=nfft, detrend=False)
    _, ref = ss.welch(x, fs=2.0, window="hann", nperseg=nperseg,
                      noverlap=nover, nfft=nfft, detrend=False)
    assert snr_db(np.asarray(got), ref) >= 200.0


@pytest.mark.parametrize("geom", [(1024, 512, 1024), (256, 128, 512)])
def test_scipy_spectrogram_geometry(geom):
    ss = pytest.importorskip("scipy.signal")
    nperseg, nover, nfft = geom
    x = RNG(0).normal(size=8192)
    _, _, got = spectral.spectrogram_scipy(x, 2.0, nperseg=nperseg, noverlap=nover,
                                           nfft=nfft, detrend=False)
    _, _, ref = ss.spectrogram(x, fs=2.0, nperseg=nperseg, noverlap=nover,
                               nfft=nfft, detrend=False)
    assert got.shape == ref.shape
    assert snr_db(np.asarray(got), ref) >= 200.0


@pytest.mark.parametrize("geom", [(1024, 512, 1024), (256, 128, 512)])
def test_scipy_csd_geometry(geom):
    ss = pytest.importorskip("scipy.signal")
    nperseg, nover, nfft = geom
    rng = RNG(0)
    x = rng.normal(size=8192)
    y = 0.6 * x + 0.4 * rng.normal(size=8192)
    _, got = spectral.welch_csd(x, y, 2.0, window="hann", nperseg=nperseg,
                                noverlap=nover, nfft=nfft, detrend=False)
    _, ref = ss.csd(x, y, fs=2.0, nperseg=nperseg, noverlap=nover, nfft=nfft,
                    detrend=False)
    assert snr_db(np.asarray(got), ref) >= 200.0


# ---------------------------------------------------------------------------
# STFT / spectrogram / ISTFT / mel geometries.
# ---------------------------------------------------------------------------


def _stft_oracle(x, nfft, hop, pad, wname="hann"):
    w = win.window_table_np(wname, nfft)
    frames = (x.shape[-1] - nfft) // hop + 1
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    return np.fft.rfft(x[..., idx] * w, n=pad, axis=-1)


@pytest.mark.parametrize("nfft,hop,pad,wname", [
    (256, 128, 256, "hann"), (256, 256, 256, "hamming"), (256, 128, 512, "hann"),
    (256, 160, 256, "hann"), (256, 100, 256, "hann"), (1024, 160, 1024, "hann"),
    (1024, 320, 1024, "hann"), (384, 128, 512, "hann"),
])
def test_stft_geometry_vs_numpy(nfft, hop, pad, wname):
    x = RNG(nfft + hop).normal(size=hop * 30 + nfft + 17)
    got = np.asarray(models.stft(x, nfft, hop=hop, window=wname, pad=pad))
    ref = _stft_oracle(x, nfft, hop, pad, wname)
    assert got.shape == ref.shape
    assert snr_db(got, ref) >= 200.0


@pytest.mark.parametrize("scale", ["power", "magnitude", "db"])
def test_spectrogram_scales(scale):
    x = RNG(21).normal(size=256 * 9)
    p = np.abs(_stft_oracle(x, 256, 128, 256)) ** 2
    want = {"power": p, "magnitude": np.sqrt(p),
            "db": 10 * np.log10(np.maximum(p, 1e-20))}[scale]
    got = np.asarray(models.spectrogram(x, 256, 128, scale=scale))
    assert snr_db(got, want) >= 200.0


def test_stft_batched_lead_dims():
    x = RNG(23).normal(size=(2, 3, 2048))
    got = np.asarray(models.stft(x, 256, hop=128))
    assert got.shape == (2, 3, 15, 129)
    assert snr_db(got, _stft_oracle(x, 256, 128, 256)) >= 200.0


def _istft_oracle(spec, nfft, hop, pad, w):
    """float64 least-squares overlap-add: sum w*frames / sum w^2."""
    frames = np.fft.irfft(spec, n=pad, axis=-1)[..., :nfft]
    F = spec.shape[-2]
    L = (F - 1) * hop + nfft
    num = np.zeros(spec.shape[:-2] + (L,))
    den = np.zeros(L)
    for f in range(F):
        num[..., f * hop : f * hop + nfft] += w * frames[..., f, :]
        den[f * hop : f * hop + nfft] += w * w
    return num / np.maximum(den, np.finfo(np.float64).tiny)


@pytest.mark.parametrize("nfft,pad,hop,F", [
    (256, 256, 128, 40), (256, 512, 256, 17), (384, 512, 128, 10),
    (128, 1024, 128, 9), (2048, 2048, 128, 8),
])
def test_istft_geometry_vs_oracle(nfft, pad, hop, F):
    rng = RNG(nfft + hop)
    spec = np.fft.rfft(rng.normal(size=(F, pad)), axis=-1)
    got = np.asarray(models.istft(spec, nfft, hop=hop, pad=pad))
    ref = _istft_oracle(spec, nfft, hop, pad, win.window_table_np("hann", nfft))
    assert got.shape == ref.shape
    assert snr_db(got, ref) >= 200.0


def test_istft_batched_lead_dims():
    rng = RNG(7)
    nfft = hop = 256
    spec = np.fft.rfft(rng.normal(size=(2, 3, 12, nfft)), axis=-1)
    got = np.asarray(models.istft(spec, nfft, hop=128))
    assert got.shape == (2, 3, 11 * 128 + nfft)
    ref = _istft_oracle(spec, nfft, 128, nfft, win.window_table_np("hann", nfft))
    assert snr_db(got, ref) >= 200.0


@pytest.mark.parametrize("nfft,hop", [(256, 128), (256, 48), (256, 100),
                                      (512, 160), (1024, 160)])
def test_mel_geometry_vs_numpy(nfft, hop):
    fs = 16000.0
    x = RNG(40 + hop).normal(size=hop * 40 + nfft)
    got = np.asarray(models.mel_spectrogram(x, fs, nfft=nfft, hop=hop, n_mels=40))
    fb = np.asarray(models.mel_filterbank(40, nfft, fs))
    ref = np.abs(_stft_oracle(x, nfft, hop, nfft)) ** 2 @ fb.T
    assert got.shape == ref.shape
    assert snr_db(got, ref) >= 200.0


def test_griffin_lim_converges():
    t = np.arange(2048)
    x = np.sin(2 * np.pi * 0.03 * t) + 0.5 * np.sin(2 * np.pi * 0.11 * t)
    mag = np.abs(np.asarray(models.stft(x, 256, hop=128)))
    y = np.asarray(models.griffin_lim(mag, 256, hop=128, n_iter=15))
    err = np.linalg.norm(np.abs(np.asarray(models.stft(y, 256, hop=128))) - mag)
    assert err / np.linalg.norm(mag) < 0.15


# ---------------------------------------------------------------------------
# Route properties read from the jaxpr.
# ---------------------------------------------------------------------------


def _sub_jaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(item, jex.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jex.Jaxpr):
                yield item


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _eqns(sub)


def _trace(fn, *args):
    return jax.make_jaxpr(fn)(*args).jaxpr


_X = np.linspace(-1.0, 1.0, 4096)
_Z = _X + 0.5j * _X[::-1]

ROUTES = {
    "fft": (fft.fft, _Z),
    "ifft": (fft.ifft, _Z),
    "fft_real": (fft.fft_real, _X),
    "bluestein": (fft.fft, _Z[:1000]),
    "fft2": (lambda z: fft.fft2(z.reshape(64, 64)), _Z),
    "convolve": (lambda z: fft.convolve(z, z), _Z),
    "rfft_split": (lambda x: fft.rfft_split(x)[0], _X),
    "pwelch": (lambda x: spectral.pwelch(x, 2.0)[0], _X),
    "csd": (lambda x: spectral.csd(x, x, 2.0)[0], _X),
    "welch": (lambda x: spectral.welch(x, 2.0, detrend=False)[1], _X),
    "stft": (lambda x: models.stft(x, 256, hop=160), _X),
    "istft": (lambda x: models.istft(models.stft(x, 256), 256), _X),
    "spectrogram": (lambda x: models.spectrogram(x, 256, 128), _X),
    "mel": (lambda x: models.mel_spectrogram(x, 16000.0, nfft=512, hop=160), _X),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_pallas_call_in_public_route(route):
    fn, arg = ROUTES[route]
    names = {e.primitive.name for e in _eqns(_trace(fn, jnp.asarray(arg)))}
    assert "pallas_call" not in names
    assert names  # the route traced to something


def _dot_precisions(fn, *args):
    precs = []
    for e in _eqns(_trace(fn, *args)):
        if e.primitive.name == "dot_general":
            precs.append(e.params["precision"])
    return precs


def _is_highest(prec):
    hi = jax.lax.Precision.HIGHEST
    return prec is not None and all(p == hi for p in (
        prec if isinstance(prec, tuple) else (prec, prec)))


def _mel(x):
    return models.mel_spectrogram(x, 16000.0, nfft=512, hop=160, n_mels=40)


def _savgol(x):
    return models.savgol_filter(x, 31, 3)


def _fft_sharded(n):
    from godsp_tpu.parallel import MeshConfig, fft_sharded, make_mesh

    mesh = make_mesh(MeshConfig(dp=1, sp=8))
    return lambda z: fft_sharded(z[:n], mesh)


@pytest.mark.parametrize("route,fn,arg", [
    ("mel_filterbank", _mel, _X),
    ("savgol_edges", _savgol, _X),
    ("fft_sharded_even", _fft_sharded(4096), _Z),
    ("fft_sharded_uneven", _fft_sharded(32), _Z),
    ("four_step", fft.fft, _Z),
])
def test_contractions_are_highest(route, fn, arg):
    if route.startswith("fft_sharded") and len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    precs = _dot_precisions(fn, jnp.asarray(arg))
    assert precs, "no matrix product traced"
    assert all(_is_highest(p) for p in precs), precs
