"""Native C++ runtime vs the NumPy reference paths."""

from fractions import Fraction

import numpy as np
import pytest

from spleeterrt_tpu import native
from spleeterrt_tpu.io import audio, resample

@pytest.fixture(autouse=True)
def _native_lib():
    # Decided per test, not at import: every xdist worker must collect the
    # same tests whatever its build of the library did.
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")


def _wav_bytes(x, sr, fmt):
    import io as _io
    import tempfile, os

    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    try:
        audio.write_wav(path, x, sr, fmt=fmt)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


@pytest.mark.parametrize("fmt", ["float32", "pcm16"])
def test_native_wav_matches_numpy(rng, fmt):
    x = np.clip(rng.standard_normal((2, 4000)) * 0.3, -0.9, 0.9).astype(
        np.float32
    )
    data = _wav_bytes(x, 44100, fmt)
    planar, rate = native.read_wav_native(data)
    ref = audio.read_wav(data)
    assert rate == ref.sample_rate == 44100
    np.testing.assert_array_equal(planar, ref.samples)


def test_native_resample_matches_numpy(rng):
    sr_in, sr_out = 48000, 44100
    x = (rng.standard_normal((2, 20000)) * 0.5).astype(np.float32)
    ref = resample.resample(x, sr_in, sr_out)

    frac = Fraction(sr_out, sr_in)
    p, q = frac.numerator, frac.denominator
    h = resample.kaiser_sinc_filter(p, q)
    got = native.resample_native(x, h, p, q, ref.shape[-1])
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_native_channel_ops(rng):
    import ctypes

    lib = native.get_lib()
    x = rng.standard_normal(3 * 100).astype(np.float32)  # interleaved, 3 ch
    out_len = 150
    planar = np.empty((3, out_len), np.float32)
    lib.srt_split_channels(x, 3, 100, 30, out_len, planar)
    ref = np.zeros((3, out_len), np.float32)
    ref[:, 30:130] = x.reshape(100, 3).T
    np.testing.assert_array_equal(planar, ref)

    inter = np.empty(100 * 3, np.float32)
    lib.srt_join_channels(planar, 3, out_len, 30, 100, inter)
    np.testing.assert_array_equal(inter, x)
