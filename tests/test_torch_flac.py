"""The port's FLAC codec (hnet_mamba_asr_torch/data/flac.py, numpy only)
against the JAX package's: the same samples, bit for bit, from the bytes
JAX's write_flac makes (mono and stereo, 16 and 24 bit, block-size edges);
the port's write_flac read back by JAX's read_flac; a CRC fault raises in
both; read_audio / audio_info dispatch; manifest_items over WAV + FLAC."""
import json

import numpy as np
import pytest

from hnet_mamba_asr_torch.data import audio as taudio
from hnet_mamba_asr_torch.data import flac as tflac
from hnet_mamba_asr_tpu.data import audio as jaudio
from hnet_mamba_asr_tpu.data import flac as jflac


def _pcm(rng, n, bps, channels):
    lim = 1 << (bps - 1)
    t = np.arange(n)
    x = (0.3 * lim * np.sin(0.011 * t)[:, None] + rng.normal(0, lim / 50, (n, channels)))
    return np.clip(np.round(x), -lim, lim - 1).astype(np.int64)


@pytest.mark.parametrize("bps,channels,n,kw", [
    (16, 1, 9001, {}), (16, 2, 7000, {"channel_mode": "mid_side"}),
    (24, 1, 5000, {}), (24, 2, 6000, {"channel_mode": "left_side"}),
    (16, 1, 4096, {}), (16, 1, 4097, {"partition_order": 2, "rice2": True}),
    (16, 2, 1, {"channel_mode": "right_side"}), (16, 1, 300, {"use_lpc": False})])
def test_decoder_equals_jax_on_jax_bytes(tmp_path, bps, channels, n, kw):
    rng = np.random.default_rng(bps * 100 + channels + n)
    x = _pcm(rng, n, bps, channels)
    path = tmp_path / "j.flac"
    jflac.write_flac(path, x, 16000, bps=bps, **kw)
    data = path.read_bytes()
    got, want = tflac.decode_flac_bytes(data), jflac.decode_flac_bytes(data)
    assert got[1:] == want[1:] == (16000, bps)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], x)
    w_got, sr = tflac.read_flac(path)
    w_want, _ = jflac.read_flac(path)
    assert sr == 16000 and w_got.dtype == w_want.dtype and np.array_equal(w_got, w_want)
    assert tflac.flac_info(path) == jflac.flac_info(path)


def test_port_writer_read_by_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = _pcm(rng, 12345, 16, 2)
    tflac.write_flac(tmp_path / "t.flac", x, 16000, channel_mode="mid_side")
    jflac.write_flac(tmp_path / "j.flac", x, 16000, channel_mode="mid_side")
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    out, sr, bps = jflac.decode_flac_bytes((tmp_path / "t.flac").read_bytes())
    np.testing.assert_array_equal(out, x)
    wave = np.clip(rng.normal(0, 0.2, 4000), -1, 1)
    tflac.write_flac(tmp_path / "f.flac", wave, 16000)
    w, _ = jflac.read_flac(tmp_path / "f.flac")
    np.testing.assert_array_equal(w, np.round(wave * 32767) / 32768.0)


def test_crc_fault_raises_in_both(tmp_path):
    rng = np.random.default_rng(4)
    tflac.write_flac(tmp_path / "c.flac", _pcm(rng, 5000, 16, 1), 16000)
    data = bytearray((tmp_path / "c.flac").read_bytes())
    data[len(data) // 2] ^= 0x40
    for mod in (tflac, jflac):
        with pytest.raises(ValueError):
            mod.decode_flac_bytes(bytes(data))
    with pytest.raises(ValueError, match="fLaC"):
        tflac.decode_flac_bytes(b"RIFFxxxx")


def test_read_audio_and_manifest_items_mix_wav_and_flac(tmp_path):
    from hnet_mamba_asr_torch.data.dataset import manifest_items
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    rng = np.random.default_rng(5)
    entries = []
    for i, text in enumerate(["a b", "b c a", "c"]):
        wave = np.clip(rng.normal(0, 0.1, 3000 + 500 * i), -1, 1)
        path = tmp_path / (f"u{i}.flac" if i % 2 else f"u{i}.wav")
        (tflac.write_flac if i % 2 else taudio.write_wav)(path, wave, 16000)
        entries.append({"id": f"u{i}", "audio": str(path), "text": text,
                        "frames": len(wave)})
        got, want = taudio.read_audio(path), jaudio.read_audio(path)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
        assert taudio.audio_info(path) == jaudio.audio_info(path)
    with pytest.raises(ValueError, match="container"):
        taudio.read_audio(tmp_path / "x.mp3")
    taudio.write_manifest(entries, tmp_path / "m.jsonl")
    tok = Tokenizer.train(["a b c", "b c a"], tmp_path / "bpe", vocab_size=8,
                          hard_vocab_limit=False)
    items = manifest_items(tmp_path / "m.jsonl", tok)
    assert [it["id"] for it in items] == ["u0", "u1", "u2"]
    for it, e in zip(items, entries):
        w, _ = jaudio.read_audio(e["audio"])
        assert it["n_samples"] == e["frames"] == len(w)
        np.testing.assert_array_equal(it["wave"], w.astype(np.float32))
        assert it["tokens"].tolist() == tok.encode(e["text"])
    assert json.loads((tmp_path / "m.jsonl").read_text().splitlines()[1])["audio"].endswith(
        ".flac")
