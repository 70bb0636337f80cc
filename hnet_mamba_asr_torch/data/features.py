"""Frozen global CMVN, counterpart of ``hnet_mamba_asr_tpu/data/features.py``
``GlobalCMVN`` and ``CMVNAccumulator``: ``(x - mean) * istd`` with ``.npz``
serialization, and the streaming fp64 statistics over a manifest that
``scripts/compute_cmvn.py`` computes."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


class GlobalCMVN:
    """Frozen global mean/variance normalization."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.istd = 1.0 / np.asarray(std, dtype=np.float32)

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        mean = torch.from_numpy(self.mean).to(feats.device)
        istd = torch.from_numpy(self.istd).to(feats.device)
        return (feats - mean) * istd

    def save(self, path: str | Path) -> None:
        np.savez(path, mean=self.mean, std=1.0 / self.istd)

    @classmethod
    def load(cls, path: str | Path) -> "GlobalCMVN":
        with np.load(path) as stats:
            return cls(stats["mean"], stats["std"])


class CMVNAccumulator:
    """Streaming fp64 mean/var statistics over valid (unpadded) frames."""

    def __init__(self, n_mels: int = 80):
        self.sum = np.zeros(n_mels, dtype=np.float64)
        self.sumsq = np.zeros(n_mels, dtype=np.float64)
        self.count = 0

    def update(self, feats, lengths=None) -> None:
        x = np.asarray(feats, dtype=np.float64)
        if x.ndim == 2:
            x = x[None]
        if lengths is not None:
            valid = np.arange(x.shape[1])[None, :] < np.asarray(lengths)[:, None]
            x = x[valid]                                 # [K, n_mels]
        else:
            x = x.reshape(-1, x.shape[-1])
        self.sum += x.sum(axis=0)
        self.sumsq += (x ** 2).sum(axis=0)
        self.count += x.shape[0]

    def finalize(self, var_floor: float = 1e-8) -> dict:
        if self.count == 0:
            raise RuntimeError("no frames accumulated")
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean ** 2, var_floor)
        return {"mean": mean.astype(np.float32), "std": np.sqrt(var).astype(np.float32),
                "count": self.count}

    def save(self, path: str | Path) -> dict:
        stats = self.finalize()
        np.savez(path, **stats)
        return stats


def compute_cmvn(manifest, *, n_mels: int = 80, device="cuda",
                 out: str | Path | None = None) -> GlobalCMVN:
    """Global CMVN over every utterance of a manifest (WAV or FLAC), one utterance at a
    time through the log-mel frontend on ``device`` (the card by default;
    ``scripts/compute_cmvn.py``); ``out`` also saves the statistics as
    ``.npz``."""
    from hnet_mamba_asr_torch.data.audio import load_manifest, read_audio
    from hnet_mamba_asr_torch.ops.melspec import log_mel_spectrogram
    acc = CMVNAccumulator(n_mels=n_mels)
    for e in load_manifest(manifest):
        wave, _ = read_audio(e["audio"])
        feats, flens = log_mel_spectrogram(
            torch.from_numpy(wave[None].astype(np.float32)).to(device), n_mels=n_mels)
        acc.update(feats[0].cpu().numpy(), [int(flens[0])])
    stats = acc.save(out) if out is not None else acc.finalize()
    return GlobalCMVN(stats["mean"], stats["std"])
