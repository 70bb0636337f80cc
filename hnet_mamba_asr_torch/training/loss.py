"""Hybrid training loss, counterpart of ``hnet_mamba_asr_tpu/training/loss.py``:
w_ctc * CTC + w_aed * AED + w_rnnt * RNNT + w_ratio * ratio, with the raw
components for logging, and a loud failure when a positive weight has no
matching component."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class HybridLossWeights:
    ctc_weight: float = 1.0
    aed_weight: float = 0.0
    ratio_weight: float = 0.0
    rnnt_weight: float = 0.0

    @classmethod
    def from_config(cls, model_conf) -> "HybridLossWeights":
        g = (model_conf or {}).get
        return cls(float(g("ctc_weight", 1.0)), float(g("aed_weight", 0.0)),
                   float(g("hnet_ratio_beta", g("ratio_weight", 0.0))),
                   float(g("rnnt_weight", 0.0)))


def combine_losses(weights: HybridLossWeights, *, ctc_loss=None, aed_loss=None,
                   ratio_loss=None, rnnt_loss=None) -> dict:
    """-> {"loss/total", "loss/ctc", "loss/aed", "loss/rnnt", "loss/ratio"}."""
    parts = {"ctc": ctc_loss, "aed": aed_loss, "ratio": ratio_loss, "rnnt": rnnt_loss}
    given = [t for t in parts.values() if t is not None]
    if not given:
        raise ValueError("combine_losses got no loss components")
    for name, value in parts.items():
        w = getattr(weights, f"{name}_weight")
        if w > 0.0 and value is None:
            raise ValueError(f"{name}_weight={w} but no {name}_loss was provided")
    zero = torch.zeros((), dtype=torch.float32, device=given[0].device)
    parts = {k: zero if v is None else v for k, v in parts.items()}
    total = sum(getattr(weights, f"{k}_weight") * v for k, v in parts.items())
    return {"loss/total": total, "loss/ctc": parts["ctc"], "loss/aed": parts["aed"],
            "loss/rnnt": parts["rnnt"], "loss/ratio": parts["ratio"]}
