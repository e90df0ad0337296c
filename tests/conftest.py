"""Test harness configuration.

Parity tests run on CPU in float64 (the reference computes in
float64/complex128); multi-device sharding tests run on a virtual
8-device CPU mesh via --xla_force_host_platform_device_count, per
SURVEY.md §4.  Environment must be set before jax initializes its
backends.  Tests that need a GPU carry the `gpu` marker and decide in a
fixture whether one is present.
"""

import os

# Force CPU whatever accelerator the host has: parity tests run in
# float64/complex128, and their timings mean nothing on the CPU anyway.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax reads JAX_PLATFORMS when it is first imported; if it was imported
# before this file set the variable, set the config directly as well.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def reference_wav_dir():
    """Directory of the go-dsp reference's binary WAV fixtures
    (read-only).  They are not part of this repository: the tests that
    use them skip where they are absent."""
    path = "/root/reference/wav"
    if not os.path.isdir(path):
        pytest.skip("reference WAV fixtures not available")
    return path
