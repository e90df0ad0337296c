"""Spectral tests; golden tables ported from reference
spectral/pwelch_test.go:28-46 and spectral_test.go:21-56, plus
scipy-style cross-checks via numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import dsputils, spectral, window

# pwelch_test.go:39-46: 100-point ramp, Fs=2, default options ->
# 129 golden Pxx values and 129 golden freqs (matplotlib-compatible).
GOLDEN_PXX = [
    3.66817103e+04, 6.16097526e+04, 3.70964854e+04, 1.76858083e+04,
    8.82747121e+03, 5.58636625e+03, 3.86686565e+03, 2.79695091e+03,
    2.14687978e+03, 1.68918004e+03, 1.36571705e+03, 1.13024093e+03,
    9.48033939e+02, 8.08850444e+02, 6.97809757e+02, 6.08092372e+02,
    5.35404251e+02, 4.74620274e+02, 4.24037212e+02, 3.81226909e+02,
    3.44548926e+02, 3.13192558e+02, 2.85886182e+02, 2.62122493e+02,
    2.41303266e+02, 2.22870690e+02, 2.06594463e+02, 1.92060902e+02,
    1.79062190e+02, 1.67411631e+02, 1.56878696e+02, 1.47375046e+02,
    1.38742768e+02, 1.30879468e+02, 1.23716560e+02, 1.17146757e+02,
    1.11127186e+02, 1.05591138e+02, 1.00482309e+02, 9.57717459e+01,
    9.14056404e+01, 8.73592894e+01, 8.36025117e+01, 8.01022290e+01,
    7.68443525e+01, 7.38005900e+01, 7.09550385e+01, 6.82933042e+01,
    6.57951735e+01, 6.34526724e+01, 6.12504908e+01, 5.91777124e+01,
    5.72271084e+01, 5.53860529e+01, 5.36493451e+01, 5.20085636e+01,
    5.04559628e+01, 4.89876620e+01, 4.75956980e+01, 4.62762918e+01,
    4.50247688e+01, 4.38355570e+01, 4.27063668e+01, 4.16321728e+01,
    4.06100428e+01, 3.96373615e+01, 3.87101146e+01, 3.78267782e+01,
    3.69842029e+01, 3.61800421e+01, 3.54128094e+01, 3.46796320e+01,
    3.39793658e+01, 3.33100629e+01, 3.26698301e+01, 3.20577904e+01,
    3.14719152e+01, 3.09112634e+01, 3.03746526e+01, 2.98605643e+01,
    2.93684407e+01, 2.88968774e+01, 2.84450603e+01, 2.80122875e+01,
    2.75973586e+01, 2.71998759e+01, 2.68188936e+01, 2.64536948e+01,
    2.61038720e+01, 2.57684964e+01, 2.54472465e+01, 2.51395088e+01,
    2.48446551e+01, 2.45624511e+01, 2.42921985e+01, 2.40336109e+01,
    2.37863119e+01, 2.35497603e+01, 2.33238184e+01, 2.31079809e+01,
    2.29019795e+01, 2.27056035e+01, 2.25183990e+01, 2.23402769e+01,
    2.21708920e+01, 2.20099898e+01, 2.18574728e+01, 2.17129732e+01,
    2.15764231e+01, 2.14476081e+01, 2.13262901e+01, 2.12124459e+01,
    2.11057929e+01, 2.10062684e+01, 2.09137648e+01, 2.08280657e+01,
    2.07491945e+01, 2.06769518e+01, 2.06112729e+01, 2.05521368e+01,
    2.04993557e+01, 2.04529802e+01, 2.04128917e+01, 2.03790224e+01,
    2.03514209e+01, 2.03299362e+01, 2.03146325e+01, 2.03054705e+01,
    1.01511907e+01,
]


class TestSegment:
    # spectral_test.go:21-56
    X10 = jnp.arange(1.0, 11.0)

    def test_noverlap_0(self):
        got = np.asarray(spectral.segment(self.X10, 4, 0))
        np.testing.assert_allclose(got, [[1, 2, 3, 4], [5, 6, 7, 8]])

    def test_noverlap_1(self):
        got = np.asarray(spectral.segment(self.X10, 4, 1))
        np.testing.assert_allclose(got, [[1, 2, 3, 4], [4, 5, 6, 7], [7, 8, 9, 10]])

    def test_noverlap_2(self):
        got = np.asarray(spectral.segment(self.X10, 4, 2))
        np.testing.assert_allclose(
            got, [[1, 2, 3, 4], [3, 4, 5, 6], [5, 6, 7, 8], [7, 8, 9, 10]]
        )

    def test_exact_length_one_segment(self):
        got = np.asarray(spectral.segment(jnp.arange(4.0), 4, 0))
        assert got.shape == (1, 4)

    def test_too_short_zero_segments(self):
        assert spectral.segment(jnp.arange(3.0), 4, 0).shape == (0, 4)


class TestPwelch:
    def test_empty_input(self):
        # pwelch_test.go:32-38
        pxx, freqs = spectral.pwelch(jnp.zeros(0), 0.0)
        assert pxx.shape == (0,) and freqs.shape == (0,)

    def test_golden_ramp(self):
        # pwelch_test.go:39-46: the end-to-end milestone of SURVEY.md §7.6.
        x = jnp.arange(100, dtype=jnp.float64)
        pxx, freqs = spectral.pwelch(x, 2.0, spectral.PwelchOptions())
        assert pxx.shape == (129,) and freqs.shape == (129,)
        assert dsputils.pretty_close(np.asarray(pxx), GOLDEN_PXX), np.asarray(pxx)[:5]
        expect_freqs = np.arange(129) * (2.0 / 256.0)
        assert dsputils.pretty_close(np.asarray(freqs), expect_freqs)

    def test_parseval_white_noise(self):
        """Integrated PSD of white noise approximates its variance."""
        rng = np.random.default_rng(0)
        x = rng.normal(size=65536)
        fs = 1000.0
        opts = spectral.PwelchOptions(nfft=1024, noverlap=512)
        pxx, freqs = spectral.pwelch(jnp.asarray(x), fs, opts)
        df = freqs[1] - freqs[0]
        total = float(jnp.sum(pxx) * df)
        assert abs(total - 1.0) < 0.05  # unit variance

    def test_scale_off(self):
        x = jnp.arange(100, dtype=jnp.float64)
        p_on, _ = spectral.pwelch(x, 2.0, spectral.PwelchOptions())
        p_off, _ = spectral.pwelch(x, 2.0, spectral.PwelchOptions(scale_off=True))
        np.testing.assert_allclose(np.asarray(p_off), np.asarray(p_on) * 2.0, rtol=1e-12)

    def test_pad_gt_nfft(self):
        """pad > nfft: window of length pad applied to the padded segment
        (pwelch.go:108-109) while Sum(w^2) uses the nfft window."""
        rng = np.random.default_rng(5)
        x = rng.normal(size=512)
        opts = spectral.PwelchOptions(nfft=128, pad=256)
        pxx, freqs = spectral.pwelch(jnp.asarray(x), 1.0, opts)
        assert pxx.shape == (129,)
        # Reproduce with a literal transcription of the reference loop.
        w_pad = np.asarray(window.hann(256), np.float64)
        w_nfft = np.asarray(window.hann(128), np.float64)
        segs = [x[i : i + 128] for i in range(0, 512 - 128 + 1, 128)]
        acc = np.zeros(129)
        for s in segs:
            padded = np.zeros(256)
            padded[:128] = s
            spec = np.fft.fft(padded * w_pad)[:129]
            d = np.abs(spec) ** 2 / len(segs)
            d[1:-1] *= 2
            acc += d
        acc /= np.sum(w_nfft**2) * 1.0
        np.testing.assert_allclose(np.asarray(pxx), acc, rtol=1e-8, atol=1e-12)

    def test_pad_lt_nfft(self):
        """pad < nfft: ZeroPadF(seg, pad) is a no-op (dsputils.go:60-63),
        so the FFT runs at nfft with the nfft window and only the first
        pad/2+1 bins are kept (pwelch.go:101,107-121); freqs use pad."""
        rng = np.random.default_rng(6)
        x = rng.normal(size=768)
        opts = spectral.PwelchOptions(nfft=256, pad=128)
        pxx, freqs = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        assert pxx.shape == (65,)
        # Literal transcription of the reference loop.
        w = np.asarray(window.hann(256), np.float64)
        segs = [x[i : i + 256] for i in range(0, 768 - 256 + 1, 256)]
        acc = np.zeros(65)
        for s in segs:
            spec = np.fft.fft(s * w)[:65]
            d = np.abs(spec) ** 2 / len(segs)
            d[1:-1] *= 2
            acc += d
        acc /= np.sum(w**2) * 2.0
        np.testing.assert_allclose(np.asarray(pxx), acc, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(freqs), np.arange(65) * (2.0 / 128), rtol=1e-12
        )

    def test_pad_lt_nfft_sharded_matches(self):
        """The sharded driver reproduces the pad < nfft semantics."""
        from godsp_tpu.parallel import MeshConfig, make_mesh, pwelch_sharded

        rng = np.random.default_rng(7)
        x = rng.normal(size=2048)
        opts = spectral.PwelchOptions(nfft=256, pad=128)
        ref, _ = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got, _ = pwelch_sharded(jnp.asarray(x), 2.0, opts, mesh=mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10)

    def test_short_input_zero_padded(self):
        x = jnp.ones(10, dtype=jnp.float64)
        pxx, freqs = spectral.pwelch(x, 1.0, spectral.PwelchOptions())
        assert pxx.shape == (129,)  # padded to nfft=256, one segment

    def test_window_by_name(self):
        x = jnp.arange(100, dtype=jnp.float64)
        p1, _ = spectral.pwelch(x, 2.0, spectral.PwelchOptions(window="hann"))
        p2, _ = spectral.pwelch(x, 2.0, spectral.PwelchOptions(window=window.hann))
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2))

    def test_batched_frames(self):
        """pwelch_from_frames vmaps over extra leading axes."""
        rng = np.random.default_rng(9)
        x = rng.normal(size=(3, 8, 256))  # 3 channels, 8 segments each
        opts = spectral.PwelchOptions(nfft=256)
        pxx, _ = spectral.pwelch_from_frames(jnp.asarray(x), 1.0, opts)
        assert pxx.shape == (3, 129)
        single, _ = spectral.pwelch_from_frames(jnp.asarray(x[1]), 1.0, opts)
        np.testing.assert_allclose(np.asarray(pxx[1]), np.asarray(single), rtol=1e-12)


class TestScipyCrossOracle:
    """Cross-validation against scipy.signal.welch — an oracle the
    reference never had (SURVEY.md §4)."""

    @pytest.mark.parametrize("noverlap", [0, 128])
    def test_matches_scipy_welch(self, noverlap):
        scipy_signal = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(0)
        fs, nfft = 100.0, 256
        x = rng.normal(size=10_000)
        pxx, freqs = spectral.pwelch(
            x, fs, spectral.PwelchOptions(nfft=nfft, noverlap=noverlap)
        )
        # scipy's hann is periodic by default; pass the reference's
        # symmetric window explicitly.  detrend must be off (the
        # reference never detrends).
        from godsp_tpu import window as win

        w = np.asarray(win.window_table_np("hann", nfft))
        f_sp, p_sp = scipy_signal.welch(
            x, fs=fs, window=w, nperseg=nfft, noverlap=noverlap,
            nfft=nfft, detrend=False, scaling="density",
        )
        np.testing.assert_allclose(np.asarray(freqs), f_sp)
        # scipy halves the Nyquist-interior doubling identically; the
        # only expected diff is fp ordering.
        np.testing.assert_allclose(np.asarray(pxx), p_sp, rtol=1e-8)


class TestCSDCoherence:
    def test_csd_of_self_equals_pwelch(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=8000)
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        pxy, f1 = spectral.csd(x, x, 2.0, opts)
        pxx, f2 = spectral.pwelch(x, 2.0, opts)
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2))
        np.testing.assert_allclose(
            np.asarray(pxy.real), np.asarray(pxx), rtol=1e-10
        )
        np.testing.assert_allclose(np.asarray(pxy.imag), 0.0, atol=1e-12)

    def test_csd_vs_scipy(self):
        ss = pytest.importorskip("scipy.signal")
        from godsp_tpu import window as win
        from godsp_tpu.dsputils import snr_db

        rng = np.random.default_rng(1)
        fs, nfft, noverlap = 100.0, 256, 128
        x = rng.normal(size=10_000)
        y = 0.7 * np.roll(x, 5) + 0.3 * rng.normal(size=10_000)
        pxy, freqs = spectral.csd(
            x, y, fs, spectral.PwelchOptions(nfft=nfft, noverlap=noverlap)
        )
        w = np.asarray(win.window_table_np("hann", nfft))
        f_sp, p_sp = ss.csd(
            x, y, fs=fs, window=w, nperseg=nfft, noverlap=noverlap,
            nfft=nfft, detrend=False, scaling="density",
        )
        np.testing.assert_allclose(np.asarray(freqs), f_sp)
        assert snr_db(np.asarray(pxy), p_sp) >= 190.0

    def test_coherence_vs_scipy(self):
        ss = pytest.importorskip("scipy.signal")
        from godsp_tpu import window as win
        from godsp_tpu.dsputils import snr_db

        rng = np.random.default_rng(2)
        fs, nfft, noverlap = 10.0, 256, 128
        x = rng.normal(size=20_000)
        y = ss.lfilter([1.0, 0.5, 0.25], [1.0], x) + 0.5 * rng.normal(size=20_000)
        cxy, freqs = spectral.coherence(
            x, y, fs, spectral.PwelchOptions(nfft=nfft, noverlap=noverlap)
        )
        w = np.asarray(win.window_table_np("hann", nfft))
        f_sp, c_sp = ss.coherence(
            x, y, fs=fs, window=w, nperseg=nfft, noverlap=noverlap,
            nfft=nfft, detrend=False,
        )
        np.testing.assert_allclose(np.asarray(freqs), f_sp)
        got = np.asarray(cxy)
        assert (got >= 0).all() and (got <= 1 + 1e-9).all()
        assert snr_db(got, c_sp) >= 180.0

    def test_errors_and_empty(self):
        with pytest.raises(ValueError, match="identical shapes"):
            spectral.csd(np.ones(100), np.ones(50), 1.0)
        pxy, freqs = spectral.csd(np.zeros(0), np.zeros(0), 1.0)
        assert pxy.shape == (0,) and freqs.shape == (0,)


class TestPeriodogram:
    def test_vs_scipy(self):
        ss = pytest.importorskip("scipy.signal")
        from godsp_tpu.dsputils import snr_db

        rng = np.random.default_rng(0)
        x = rng.normal(size=1000)
        pxx, freqs = spectral.periodogram(x, 10.0)
        f_sp, p_sp = ss.periodogram(x, fs=10.0, window="boxcar", detrend=False)
        np.testing.assert_allclose(np.asarray(freqs), f_sp)
        assert snr_db(np.asarray(pxx), p_sp) >= 190.0

    def test_windowed_and_padded(self):
        from godsp_tpu.dsputils import snr_db

        rng = np.random.default_rng(1)
        x = rng.normal(size=500)
        pxx, freqs = spectral.periodogram(x, 2.0, window="hann", pad=1024)
        assert pxx.shape == (513,)
        ref, _ = spectral.pwelch(
            x, 2.0, spectral.PwelchOptions(nfft=500, window="hann", pad=1024)
        )
        assert snr_db(np.asarray(pxx), np.asarray(ref)) >= 250.0

    def test_empty(self):
        pxx, freqs = spectral.periodogram(np.zeros(0), 1.0)
        assert pxx.shape == (0,)


class TestCsdPadLtNfft:
    def test_csd_pad_lt_nfft_matches_pwelch(self):
        """csd(x, x) == pwelch(x) must hold for pad < nfft too (the
        ZeroPadF no-op semantics, dsputils.go:60-63)."""
        rng = np.random.default_rng(8)
        x = rng.normal(size=1024)
        opts = spectral.PwelchOptions(nfft=256, pad=128, noverlap=64)
        pxy, f1 = spectral.csd(jnp.asarray(x), jnp.asarray(x), 2.0, opts)
        pxx, f2 = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        assert pxy.shape == (65,)
        np.testing.assert_allclose(
            np.asarray(pxy.real), np.asarray(pxx), rtol=1e-10
        )
        np.testing.assert_allclose(np.asarray(pxy.imag), 0.0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2))

    def test_coherence_pad_lt_nfft(self):
        rng = np.random.default_rng(9)
        x = rng.normal(size=2048)
        y = 0.7 * x + 0.3 * rng.normal(size=2048)
        opts = spectral.PwelchOptions(nfft=256, pad=128, noverlap=128)
        cxy, _ = spectral.coherence(jnp.asarray(x), jnp.asarray(y), 2.0, opts)
        c = np.asarray(cxy)
        assert c.shape == (65,)
        assert np.all(c >= 0) and np.all(c <= 1 + 1e-9)


class TestScipyWelch:
    """spectral.welch — the scipy-compatible estimator (periodic
    windows, detrend, density/spectrum, mean/median) vs scipy.signal
    float64.  The reference-parity path stays in pwelch."""

    @staticmethod
    def _x(n=4096, seed=0):
        return np.random.default_rng(seed).normal(size=n)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(fs=10.0),
            dict(fs=2.0, nperseg=512, noverlap=384),
            dict(nperseg=256, nfft=512),
            dict(nperseg=255, nfft=255),
            dict(nperseg=256, detrend="linear"),
            dict(nperseg=256, detrend=False),
            dict(nperseg=256, scaling="spectrum"),
            dict(nperseg=256, average="median"),
            dict(window="hamming", nperseg=256),
            dict(window=("kaiser", 8.0), nperseg=256),
            dict(window="boxcar", nperseg=256),
            dict(nperseg=256, return_onesided=False),
        ],
    )
    def test_scipy_parity(self, kw):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch

        x = self._x()
        f1, p1 = welch(x, **kw)
        f2, p2 = ss.welch(x, **kw)
        np.testing.assert_allclose(np.asarray(f1), f2, rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)

    def test_complex_two_sided(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch

        rng = np.random.default_rng(1)
        z = rng.normal(size=2048) + 1j * rng.normal(size=2048)
        f1, p1 = welch(z, fs=5.0, nperseg=256)
        f2, p2 = ss.welch(z, fs=5.0, nperseg=256, return_onesided=False)
        np.testing.assert_allclose(np.asarray(f1), f2, rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)

    def test_batched_and_axis(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch

        rng = np.random.default_rng(2)
        xb = rng.normal(size=(3, 2048))
        _, p1 = welch(xb, nperseg=256)
        _, p2 = ss.welch(xb, nperseg=256, axis=-1)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)
        _, p1 = welch(xb.T, nperseg=256, axis=0)
        _, p2 = ss.welch(xb.T, nperseg=256, axis=0)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)

    def test_short_input_clips_nperseg(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch

        x = self._x(100, 3)
        f1, p1 = welch(x, nperseg=256)
        with pytest.warns(UserWarning):
            f2, p2 = ss.welch(x, nperseg=256)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)

    def test_validation(self):
        from godsp_tpu.spectral import welch

        with pytest.raises(ValueError):
            welch(np.zeros(100), nperseg=64, noverlap=64)
        with pytest.raises(ValueError):
            welch(np.zeros(100), nperseg=64, nfft=32)
        with pytest.raises(ValueError):
            welch(np.zeros(100), scaling="bogus")
        with pytest.raises(ValueError):
            welch(np.zeros(100), average="bogus")


class TestScipyCsdCoherence:
    """welch_csd / welch_coherence — scipy.signal.csd/coherence parity."""

    @staticmethod
    def _xy():
        rng = np.random.default_rng(0)
        x = rng.normal(size=4096)
        return x, 0.5 * x + rng.normal(size=4096)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(fs=4.0),
            dict(nperseg=512, noverlap=400),
            dict(nperseg=256, nfft=512),
            dict(nperseg=256, detrend="linear"),
            dict(nperseg=256, scaling="spectrum"),
            dict(nperseg=256, average="median"),
            dict(nperseg=256, return_onesided=False),
            dict(window=("kaiser", 7.0), nperseg=256),
        ],
    )
    def test_csd_parity(self, kw):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch_csd

        x, y = self._xy()
        f1, p1 = welch_csd(x, y, **kw)
        f2, p2 = ss.csd(x, y, **kw)
        np.testing.assert_allclose(np.asarray(f1), f2, rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)

    def test_csd_complex_and_self(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch, welch_csd

        rng = np.random.default_rng(1)
        z1 = rng.normal(size=2048) + 1j * rng.normal(size=2048)
        z2 = rng.normal(size=2048) + 1j * rng.normal(size=2048)
        _, p1 = welch_csd(z1, z2, nperseg=256)
        _, p2 = ss.csd(z1, z2, nperseg=256, return_onesided=False)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-9, atol=1e-14)
        # self-CSD equals welch exactly
        x, _ = self._xy()
        _, pxx = welch(x, nperseg=256)
        _, pself = welch_csd(x, x, nperseg=256)
        np.testing.assert_allclose(
            np.asarray(pself.real), np.asarray(pxx), rtol=1e-12, atol=1e-18
        )

    def test_coherence(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import welch_coherence

        x, y = self._xy()
        f1, c1 = welch_coherence(x, y, fs=4.0, nperseg=256)
        f2, c2 = ss.coherence(x, y, fs=4.0, nperseg=256)
        np.testing.assert_allclose(np.asarray(c1), c2, rtol=1e-9, atol=1e-13)

    def test_shape_mismatch(self):
        from godsp_tpu.spectral import welch_csd

        with pytest.raises(ValueError):
            welch_csd(np.zeros(100), np.zeros(99))


class TestScipySpectrogram:
    """spectral.spectrogram_scipy — scipy.signal.spectrogram parity
    (freq axis first, time axis last; tukey default window)."""

    @staticmethod
    def _x(n=8192):
        return np.random.default_rng(0).normal(size=n)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(fs=4.0),
            dict(nperseg=512, noverlap=128),
            dict(nperseg=256, nfft=512),
            dict(window="hann", nperseg=256, noverlap=128),
            dict(nperseg=256, mode="magnitude"),
            dict(nperseg=256, mode="complex"),
            dict(nperseg=256, scaling="spectrum"),
            dict(nperseg=256, detrend="linear"),
            dict(nperseg=256, return_onesided=False),
        ],
    )
    def test_scipy_parity(self, kw):
        import scipy.signal as ss

        from godsp_tpu.spectral import spectrogram_scipy

        x = self._x()
        f1, t1, s1 = spectrogram_scipy(x, **kw)
        f2, t2, s2 = ss.spectrogram(x, **kw)
        np.testing.assert_allclose(np.asarray(f1), f2, rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(t1), t2, rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(s1), s2, rtol=1e-9, atol=1e-13)

    def test_complex_input(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import spectrogram_scipy

        rng = np.random.default_rng(1)
        z = rng.normal(size=4096) + 1j * rng.normal(size=4096)
        _, _, s1 = spectrogram_scipy(z, nperseg=256)
        _, _, s2 = ss.spectrogram(z, nperseg=256, return_onesided=False)
        np.testing.assert_allclose(np.asarray(s1), s2, rtol=1e-9, atol=1e-13)

    def test_validation(self):
        from godsp_tpu.spectral import spectrogram_scipy

        with pytest.raises(ValueError):
            spectrogram_scipy(np.zeros(100), mode="bogus")


class TestLombScargle:
    def test_scipy_parity(self):
        import scipy.signal as ss

        from godsp_tpu.spectral import lombscargle

        rng = np.random.default_rng(2)
        t = np.sort(rng.uniform(0, 100, 500))
        y = np.sin(2 * np.pi * 0.3 * t) + 0.5 * rng.normal(size=500)
        freqs = np.linspace(0.01, 5, 300) * 2 * np.pi
        for kw in (dict(), dict(precenter=True), dict(normalize=True)):
            p1 = np.asarray(lombscargle(t, y, freqs, **kw))
            if kw.get("precenter"):
                # scipy >= 1.17 deprecates precenter=True in favor of
                # pre-subtracting the mean; our API keeps the flag, so
                # compare against the documented exact substitution.
                p2 = ss.lombscargle(t, y - y.mean(), freqs)
            else:
                p2 = ss.lombscargle(t, y, freqs, **kw)
            np.testing.assert_allclose(p1, p2, rtol=1e-9, atol=1e-11)

    def test_detects_tone(self):
        from godsp_tpu.spectral import lombscargle

        rng = np.random.default_rng(3)
        t = np.sort(rng.uniform(0, 50, 400))
        f0 = 1.3
        y = np.cos(2 * np.pi * f0 * t)
        freqs = np.linspace(0.1, 3.0, 291) * 2 * np.pi
        p = np.asarray(lombscargle(t, y, freqs))
        assert abs(freqs[np.argmax(p)] / (2 * np.pi) - f0) < 0.02

    def test_validation(self):
        from godsp_tpu.spectral import lombscargle

        with pytest.raises(ValueError):
            lombscargle(np.zeros(5), np.zeros(6), np.ones(3))
