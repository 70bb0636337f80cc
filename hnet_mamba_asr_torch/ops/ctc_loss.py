"""CTC loss, counterpart of ``hnet_mamba_asr_tpu/ops/ctc_loss.py``.

The JAX package runs its own log-space forward algorithm as an XLA scan
because the TPU has no CTC op; on the card this is torch's native
``F.ctc_loss``, the op the reference repo used, with ``zero_infinity=True``
(an utterance no alignment can emit contributes 0 loss and 0 gradient) and
``reduction="none"``. Its CUDA backward sums with atomics, so a gradient
varies in its last bits from run to run. ``ctc_infeasible`` counts the rows
that zero_infinity silences.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_infeasible(feat_lengths: torch.Tensor, targets: torch.Tensor,
                   target_lengths: torch.Tensor) -> torch.Tensor:
    """[B] bool: utterances a CTC alignment cannot emit (enc_len < tok_len +
    #adjacent repeats)."""
    B, U = targets.shape
    if U > 1:
        pair_ok = (torch.arange(U - 1, device=targets.device)[None, :]
                   < (target_lengths - 1)[:, None])
        reps = ((targets[:, 1:] == targets[:, :-1]) & pair_ok).sum(dim=1)
    else:
        reps = torch.zeros(B, dtype=torch.int64, device=targets.device)
    return feat_lengths < target_lengths + reps


def ctc_loss(log_probs: torch.Tensor, feat_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, *, blank_id: int) -> torch.Tensor:
    """log_probs [B, T, C] (log-softmaxed), feat_lengths [B], targets [B, U]
    (padding past target_lengths ignored), target_lengths [B] -> the
    per-utterance negative log-likelihood [B], fp32, 0 for infeasible rows."""
    nll = F.ctc_loss(log_probs.float().transpose(0, 1), targets.long(),
                     feat_lengths.long(), target_lengths.long(), blank=blank_id,
                     reduction="none", zero_infinity=True)
    return nll
