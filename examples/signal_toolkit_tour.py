"""Tour of the signal-processing toolkit: filter design ->
filtering -> spectral analysis -> LTI simulation -> splines ->
ShortTimeFFT.  Everything matches scipy.signal semantics; the compute
paths run on the framework's FFT/scan kernels.

Run: python examples/signal_toolkit_tour.py   (CPU or GPU)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

# float64 parity on a CPU run; accelerators keep the float32 policy.
if _os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

import numpy as np

import godsp_tpu.models as M  # noqa: E402
from godsp_tpu import fft as gfft  # noqa: E402
from godsp_tpu.spectral import welch  # noqa: E402

rng = np.random.default_rng(0)
fs = 8000.0
t = np.arange(int(2 * fs)) / fs
sig = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1800 * t)
       + 0.2 * rng.normal(size=t.shape))

# --- 1. design the minimum-order elliptic bandpass for a spec --------------
wp, ws = [350, 550], [200, 700]  # Hz passband/stopband edges
N, wn = M.ellipord(wp, ws, gpass=1, gstop=50, fs=fs)
sos = M.ellip(N, 1, 50, wn, btype="bandpass", output="sos", fs=fs)
print(f"elliptic bandpass: order {N} at wn = {np.round(wn, 1)} Hz")

# --- 2. zero-phase filter, then measure the PSD before/after ---------------
filtered = np.asarray(M.sosfiltfilt(sos, sig))
f_b, p_before = welch(sig, fs=fs, nperseg=1024)
f_a, p_after = welch(filtered, fs=fs, nperseg=1024)
i440 = np.argmin(np.abs(np.asarray(f_b) - 440))
i1800 = np.argmin(np.abs(np.asarray(f_b) - 1800))
print(f"PSD @440 Hz: {np.asarray(p_before)[i440]:.2e} -> "
      f"{np.asarray(p_after)[i440]:.2e}")
print(f"PSD @1800 Hz: {np.asarray(p_before)[i1800]:.2e} -> "
      f"{np.asarray(p_after)[i1800]:.2e} (stopband)")

# --- 3. equiripple FIR + minimum-phase version -----------------------------
taps = M.remez(101, [0, 500, 700, fs / 2], [1, 0], fs=fs)
mp = M.minimum_phase(taps if len(taps) % 2 else taps[:-1])
print(f"remez lowpass: {len(taps)} taps -> minimum-phase {len(mp)} taps")

# --- 4. LTI: simulate the analog prototype's step response -----------------
b_a, a_a = M.butter(3, 2 * np.pi * 500, analog=True)
t_step, y_step = M.step((b_a, a_a))
print(f"analog step response: settles to {float(np.ravel(y_step)[-1]):.4f} "
      f"over {t_step[-1] * 1e3:.1f} ms")

# --- 5. spline smoothing (exact DCT-II route) ------------------------------
noisy = np.sin(2 * np.pi * 3 * np.linspace(0, 1, 400)) + 0.3 * rng.normal(
    size=400)
coef = np.asarray(M.cspline1d(noisy, lamb=50.0))
smooth = np.asarray(M.cspline1d_eval(coef, np.arange(400)))
print(f"smoothing spline residual rms: "
      f"{np.sqrt(np.mean((smooth - noisy) ** 2)):.3f}")

# --- 6. ShortTimeFFT scalogram of a chirp ----------------------------------
chirp = np.asarray(M.chirp(t, f0=100, t1=2.0, f1=2000))
S = M.ShortTimeFFT.from_window("hann", fs, 256, 192, scale_to="psd")
spec = np.asarray(S.spectrogram(chirp))
ridge = np.asarray(S.f)[np.argmax(spec, axis=0)]
print(f"chirp ridge: {ridge[5]:.0f} Hz -> {ridge[-5]:.0f} Hz "
      f"across {spec.shape[1]} slices")

# --- 7. CWT peak picking ---------------------------------------------------
peaks = M.find_peaks_cwt(np.sin(2 * np.pi * 2 * np.linspace(0, 1, 500)),
                         np.arange(10, 60))
print(f"find_peaks_cwt located maxima at samples {list(peaks)}")

# --- 8. one FFT sanity check through the kernel chain ----------------------
x = rng.normal(size=4096)
from godsp_tpu.utils import to_host
err = np.abs(to_host(gfft.fft(x)) - np.fft.fft(x)).max()
print(f"fft parity vs numpy at n=4096: {err:.2e}")
