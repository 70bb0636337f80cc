"""Audio files and JSONL manifests, counterpart of ``read_wav`` /
``write_wav`` / ``read_audio`` / ``audio_info`` in
``hnet_mamba_asr_tpu/data/audio.py`` and ``load_manifest`` /
``write_manifest`` in ``hnet_mamba_asr_tpu/data/manifests.py`` (the port
keeps its own copies). WAV and FLAC (``data/flac.py``) decode in-repo;
speed perturbation is not ported.

A manifest line is ``{"id", "audio", "text", "frames"}`` with ``frames`` the
sample count.
"""
from __future__ import annotations

import json
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """WAV file -> (float64 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float64) / (1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str | Path, wave_f: np.ndarray, sample_rate: int) -> None:
    """float waveform in [-1, 1] -> PCM16 WAV."""
    x = np.clip(np.asarray(wave_f, dtype=np.float64), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def audio_info(path: str | Path) -> dict:
    """{frames, sample_rate, duration_s} without decoding the payload."""
    p = Path(path)
    if p.suffix.lower() == ".flac":
        from hnet_mamba_asr_torch.data.flac import flac_info
        si = flac_info(p)
        frames, sr = si["total_samples"], si["sample_rate"]
    else:
        with wave.open(str(p), "rb") as w:
            frames, sr = w.getnframes(), w.getframerate()
    return {"frames": frames, "sample_rate": sr, "duration_s": frames / sr}


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Dispatch on extension: WAV and FLAC both decode in-repo."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix in (".wav", ".wave"):
        return read_wav(p)
    if suffix == ".flac":
        from hnet_mamba_asr_torch.data.flac import read_flac
        return read_flac(p)
    raise ValueError(
        f"{path}: unsupported audio container {suffix!r} (WAV and FLAC "
        "supported natively)")


def load_manifest(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_manifest(entries, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as w:
        for e in entries:
            w.write(json.dumps(e) + "\n")
    return path
