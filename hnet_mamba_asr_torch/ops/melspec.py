"""Log-mel spectrogram: framing + rFFT + mel + log, in PyTorch.

Counterpart of ``hnet_mamba_asr_tpu/ops/melspec.py``, with its contract:

    waveform [B, N] @ 16 kHz -> feats [B, T, n_mels],  T = 1 + (N - win) // hop

- ``center=False`` framing: every frame covers real samples only, so features
  of a zero-padded batch equal per-utterance features on all valid frames.
- periodic Hann window; power spectrum; HTK mel scale with unnormalized
  triangular filters; log with a 1e-10 floor.
- integer waveforms are int16 PCM and are scaled by 1/32768.

The spectrum is ``torch.fft.rfft`` of the windowed frames.
"""
from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000
N_MELS = 80
WIN_LENGTH = 400          # 25 ms
HOP_LENGTH = 160          # 10 ms -> 100 Hz
LOG_FLOOR = 1e-10


def frame_count(num_samples, win_length: int = WIN_LENGTH,
                hop_length: int = HOP_LENGTH):
    """Feature-frame count for an n-sample waveform (center=False contract);
    a tensor in gives a tensor out."""
    n = (num_samples - win_length) // hop_length + 1
    return n.clamp(min=0) if torch.is_tensor(n) else np.maximum(n, 0)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """[n_freqs, n_mels] triangular filterbank, HTK mel scale, no normalization."""
    if f_max is None:
        f_max = sample_rate / 2.0
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)                                  # [n_mels + 2]
    # triangle m spans (hz[m], hz[m+1], hz[m+2])
    lower = (freqs[:, None] - hz_pts[None, :-2]) / np.maximum(
        hz_pts[1:-1] - hz_pts[:-2], 1e-10)[None, :]
    upper = (hz_pts[None, 2:] - freqs[:, None]) / np.maximum(
        hz_pts[2:] - hz_pts[1:-1], 1e-10)[None, :]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (equal to torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def log_mel_spectrogram(wave: torch.Tensor, lengths: torch.Tensor | None = None, *,
                        win_length: int = WIN_LENGTH, hop_length: int = HOP_LENGTH,
                        n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE):
    """waveform [B, N] (or [N]) -> (log-mel feats [B, T, n_mels] fp32,
    feat_lengths [B]).

    T is set by the PADDED length N; frames beyond ``feat_lengths`` see zero
    padding and are masked downstream.
    """
    if wave.dim() == 1:
        wave = wave[None, :]
    B, N = wave.shape
    if N < win_length:
        raise ValueError(f"waveform ({N} samples) shorter than one window ({win_length})")
    if lengths is None:
        lengths = torch.full((B,), N, dtype=torch.int64, device=wave.device)
    if wave.dtype.is_floating_point:
        wave = wave.float()
    else:
        wave = wave.float() * (1.0 / 32768.0)     # int16 PCM wire format
    frames = wave.unfold(1, win_length, hop_length)              # [B, T, win]
    window = torch.from_numpy(hann_window(win_length)).to(wave.device)
    spec = torch.fft.rfft(frames * window, dim=-1)               # [B, T, win//2+1]
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(win_length // 2 + 1, n_mels,
                                         sample_rate)).to(wave.device)
    feats = torch.log(torch.clamp(power @ fb, min=LOG_FLOOR))
    return feats, frame_count(lengths.long(), win_length, hop_length)
