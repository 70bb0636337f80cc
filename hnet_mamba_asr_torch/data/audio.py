"""Audio files, speed perturbation and JSONL manifests, counterpart of
``hnet_mamba_asr_tpu/data/audio.py`` and of ``load_manifest`` /
``write_manifest`` in ``hnet_mamba_asr_tpu/data/manifests.py`` (the port
keeps its own copies). WAV and FLAC (``data/flac.py``) decode in-repo.

Speed perturbation is Kaldi's: play the audio at ``factor`` x by resampling
from sr to round(sr / factor), the ratio reduced by
``Fraction.limit_denominator(1000)`` (10/9 for 0.9 and 10/11 for 1.1 at 16
kHz) through a Kaiser-windowed sinc bank of ``2 * 16 * max(up, down) + 1``
taps (321 and 353). ``resample`` runs the host library's sparse polyphase
loop (``data/host_audio.py``); ``resample_plain`` is its numpy twin.

A manifest line is ``{"id", "audio", "text", "frames"}`` with ``frames`` the
sample count.
"""
from __future__ import annotations

import json
import wave
from fractions import Fraction
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


# ── speed perturbation (polyphase windowed-sinc resampling) ───────────────────
_KERNEL_CACHE: dict = {}


def _resample_kernel(up: int, down: int, half_width: int = 16, beta: float = 8.555):
    """Polyphase lowpass bank: Kaiser-windowed sinc at cutoff min(1/up, 1/down),
    cached per arguments and write-protected."""
    key = (up, down, half_width, beta)
    kern = _KERNEL_CACHE.get(key)
    if kern is None:
        cutoff = min(1.0 / up, 1.0 / down)
        half_len = half_width * max(up, down)
        t = np.arange(-half_len, half_len + 1, dtype=np.float64)
        kern = cutoff * np.sinc(cutoff * t) * np.kaiser(2 * half_len + 1, beta)
        kern = kern * up
        kern.setflags(write=False)
        _KERNEL_CACHE[key] = kern
    return kern


def _ratio(orig_sr: int, new_sr: int) -> tuple[int, int, np.ndarray]:
    frac = Fraction(new_sr, orig_sr).limit_denominator(1000)
    up, down = frac.numerator, frac.denominator
    return up, down, _resample_kernel(up, down)


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Rational-ratio polyphase resampling (float64), in the host library:
    out[j] = sum over s of x[s] kern[j down + len(kern) // 2 - s up]."""
    if orig_sr == new_sr:
        return x.copy()
    from hnet_mamba_asr_torch.data.host_audio import resample_poly
    up, down, kern = _ratio(orig_sr, new_sr)
    n_out = int(np.ceil(len(x) * up / down))
    return resample_poly(np.asarray(x, np.float64), kern, up, down, n_out)


def resample_plain(x: np.ndarray, orig_sr: int, new_sr: int, block: int = 1 << 15) -> np.ndarray:
    """``resample``'s numpy twin: the same sparse sum, vectorised over blocks
    of outputs (each output gathers its ~len(kern) / up taps)."""
    if orig_sr == new_sr:
        return x.copy()
    x = np.asarray(x, np.float64)
    up, down, kern = _ratio(orig_sr, new_sr)
    n, nk = len(x), len(kern)
    n_out = int(np.ceil(n * up / down))
    taps = -(-nk // up) + 1
    out = np.empty(n_out, np.float64)
    for j0 in range(0, n_out, block):
        t = np.arange(j0, min(n_out, j0 + block), dtype=np.int64) * down + nk // 2
        s = np.minimum(t // up, n - 1)[:, None] - np.arange(taps)[::-1][None, :]
        k = t[:, None] - s * up
        ok = (s >= 0) & (k >= 0) & (k < nk)
        out[j0:j0 + len(t)] = np.where(ok, x[np.clip(s, 0, n - 1)] * kern[np.clip(k, 0, nk - 1)],
                                       0.0).sum(axis=1)
    return out


def apply_speed_perturb(wave_f: np.ndarray, sample_rate: int, factor: float) -> np.ndarray:
    """Kaldi-style speed perturbation: play audio at ``factor`` x (duration
    scales by 1 / factor) by resampling; the transcript is unchanged.
    factor 1.0 is the identity."""
    if factor == 1.0:
        return wave_f
    virtual_sr = int(round(sample_rate / float(factor)))
    return resample(np.asarray(wave_f, dtype=np.float64), sample_rate, virtual_sr)


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
