"""Frozen global CMVN, counterpart of ``hnet_mamba_asr_tpu/data/features.py``
``GlobalCMVN``: ``(x - mean) * istd`` with ``.npz`` serialization."""
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
