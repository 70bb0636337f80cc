"""The port's host audio library (hnet_mamba_asr_torch/csrc/host_audio.cpp,
bound by data/host_audio.py) against its numpy twins and the JAX package:
polyphase resampling at the speed-perturb factors 0.9 / 1.1 (fp64, 1e-12
of the output's max), ``perturbed_samples`` == the perturbed length, FLAC
decoding bit for bit (mono, block sizes 192 / 1152 / 4096, verbatim and
constant subframes, stereo), and a corrupt frame CRC raising."""
import shutil

import numpy as np
import pytest

from hnet_mamba_asr_torch.data import audio as taudio
from hnet_mamba_asr_torch.data import flac as tflac
from hnet_mamba_asr_torch.data import host_audio
from hnet_mamba_asr_torch.data.dataset import perturbed_samples
from hnet_mamba_asr_tpu.data import audio as jaudio
from hnet_mamba_asr_tpu.data import flac as jflac

pytestmark = pytest.mark.skipif(shutil.which("c++") is None,
                                reason="no C++ compiler to build the host audio library")
RESAMPLE_RTOL = 1e-12


@pytest.mark.parametrize("n", [1, 5, 399, 4000, 16001])
@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_resample_matches_twin_and_jax(n, factor):
    x = np.random.default_rng(n).normal(size=n)
    got = taudio.apply_speed_perturb(x, 16000, factor)
    sr = int(round(16000 / factor))
    plain = taudio.resample_plain(x, 16000, sr)
    want = jaudio.apply_speed_perturb(x, 16000, factor)
    assert got.dtype == want.dtype == np.float64
    assert len(got) == len(plain) == len(want) == perturbed_samples(n, 16000, factor)
    scale = np.abs(want).max()
    assert np.abs(got - plain).max() <= RESAMPLE_RTOL * scale
    assert np.abs(got - want).max() <= RESAMPLE_RTOL * scale
    up, down, kern = taudio._ratio(16000, sr)
    assert (up, down, len(kern)) == ((10, 9, 321) if factor == 0.9 else (10, 11, 353))


def test_perturbed_samples_sweep():
    for n in list(range(1, 300)) + [4000, 16000, 160001, 254321]:
        for f in (0.9, 1.0, 1.1):
            x = np.zeros(n)
            assert perturbed_samples(n, 16000, f) == len(taudio.apply_speed_perturb(x, 16000, f))


def _pcm(rng, n, channels=1):
    t = np.arange(n)
    x = 9000 * np.sin(0.013 * t)[:, None] + rng.normal(0, 400, (n, channels))
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


@pytest.mark.parametrize("n,channels,kw", [
    (9001, 1, {}), (5000, 1, {"blocksize": 192}), (7000, 1, {"blocksize": 1152}),
    (4096, 1, {"blocksize": 4096}), (3000, 1, {"use_lpc": False}),
    (6000, 2, {"channel_mode": "mid_side"})])
def test_flac_decode_bit_exact(tmp_path, n, channels, kw):
    x = _pcm(np.random.default_rng(n + channels), n, channels)
    path = tmp_path / "x.flac"
    tflac.write_flac(path, x, 16000, **kw)
    data = path.read_bytes()
    got = host_audio.flac_decode(data)
    plain = tflac.decode_flac_bytes(data)
    assert got[1:] == plain[1:] == (16000, 16)
    assert got[0].dtype == np.int32 and np.array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[0], x)
    w_got, _ = tflac.read_flac(path)
    w_jax, _ = jflac.read_flac(path)
    assert w_got.dtype == w_jax.dtype and np.array_equal(w_got, w_jax)


def test_flac_verbatim_and_constant_subframes(tmp_path):
    """Silence (constant subframes) then white noise (verbatim: no
    predictor beats raw samples)."""
    rng = np.random.default_rng(11)
    x = np.concatenate([np.zeros(4096, np.int64), rng.integers(-32768, 32768, 4096)])
    path = tmp_path / "v.flac"
    jflac.write_flac(path, x, 16000)
    got, sr, bps = host_audio.flac_decode(path.read_bytes())
    np.testing.assert_array_equal(got[:, 0], x)
    np.testing.assert_array_equal(got, jflac.decode_flac_bytes(path.read_bytes())[0])


def test_flac_corrupt_crc_raises(tmp_path):
    path = tmp_path / "c.flac"
    tflac.write_flac(path, _pcm(np.random.default_rng(4), 5000), 16000)
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x40
    with pytest.raises(ValueError):
        host_audio.flac_decode(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        host_audio.flac_decode(b"RIFF" + bytes(64))
