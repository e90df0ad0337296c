"""chip_smoke.py: each phase at a tiny size on the CPU (the sizes are
arguments; the script's main() supplies the deployment sizes and alone
demands a GPU), the refusal to run without one, and the GPU run itself
(marked gpu: it skips where no card is present)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture
def ctx(tmp_path):
    return chip_smoke.Ctx(seed=0, tmpdir=str(tmp_path), reps=1)


def _assert_rows(rows, names):
    assert [r.name for r in rows if not r.info] == names
    for r in rows:
        assert r.ok, r.line()
        assert "FAIL" not in r.line()


PHASES = {
    "transfer": (lambda c: chip_smoke.phase_transfer(c, (16, 8)), ["transfer"]),
    "floors": (lambda c: chip_smoke.phase_floors(c, copy_bytes=1 << 12, mm_n=32), []),
    "fft": (
        lambda c: chip_smoke.phase_fft(c, batch=(4, 64), square=32, singles=(1 << 16,)),
        ["fft.fft", "fft.ifft(fft)"] * 2
        + ["fft.fft", "fft.fft[tones]", "fft.ifft(fft)", "fft.fft_real"],
    ),
    "bluestein": (
        lambda c: chip_smoke.phase_bluestein(c, sizes=(100, 121), batch=4),
        ["fft.fft[bluestein]"] * 2,
    ),
    "fft2_convolve": (
        lambda c: chip_smoke.phase_fft2_convolve(c, n2d=32, nconv=1 << 10),
        ["fft.fft2", "fft.convolve"],
    ),
    "pwelch": (
        lambda c: chip_smoke.phase_pwelch(c, n=1 << 14),
        ["spectral.pwelch"] * 2 + ["spectral.csd"],
    ),
    "wav_psd": (
        lambda c: chip_smoke.phase_wav_psd(
            c, n=1 << 16, block_size=1 << 12, segs_per_chunk_shard=2,
            checkpoint_every=1),
        ["models.wav_psd", "models.wav_psd[resume]"],
    ),
    "stft_istft": (
        lambda c: chip_smoke.phase_stft_istft(c, n=1 << 13),
        ["models.stft", "models.istft(stft)"],
    ),
    "mel": (
        lambda c: chip_smoke.phase_mel(c, n=1 << 13),
        ["models.mel_spectrogram"],
    ),
    "four": (
        lambda c: chip_smoke.phase_four(
            c, n=1 << 12, n_fft=1 << 12, stft_n=1 << 13, segs_per_chunk_shard=2),
        ["parallel.pwelch_sharded[dp=1,sp=4]", "parallel.pwelch_sharded[dp=2,sp=2]",
         "parallel.StreamingPwelch[resume,sp=4]", "parallel.fft_sharded[sp=4]",
         "parallel.spectrogram_sharded[sp=4]", "parallel.istft_sharded[sp=4]"],
    ),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_tiny(phase, ctx):
    run, names = PHASES[phase]
    _assert_rows(run(ctx), names)


def test_every_single_device_phase_is_tested():
    assert set(chip_smoke.SINGLE) | {"four"} == set(PHASES)


def test_shard_row_rejects_a_mismatch(ctx):
    """A sharded result off the single-device one by more than the
    tolerance fails however good its SNR."""
    import jax.numpy as jnp
    import numpy as np

    single = np.ones(64)
    got = jnp.asarray(single * (1 + 1e-3))
    row = chip_smoke._shard_row(ctx, "x", "[64]", got, single, 0.0, 1.0)
    assert not row.ok and "FAIL" in row.line()


def test_transfer_row_fails_when_not_exact():
    row = chip_smoke.Row("transfer", "[1]", bound_db=None, passed=False)
    assert not row.ok and row.line().startswith("[FAIL]")


def test_main_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "enable_compile_cache", lambda: "")
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


@pytest.fixture
def gpu_host():
    """Skip unless an NVIDIA GPU answers nvidia-smi (decided here, never
    at import)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this host")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_host):
    """The script as a user runs it, in its own process so JAX there
    sees the card (this test process is held to the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
