"""RNN-T (transducer) loss, the plain version: counterpart of
``hnet_mamba_asr_tpu/ops/rnnt_loss.py``, in JAX's formulation.

The transducer objective marginalizes every monotonic alignment of the
labels y[0:U) to T encoder frames through the (T, U+1) lattice

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])
    loss = -(alpha[T-1, U] + blank[T-1, U])

as JAX computes it: a loop over frames with the alpha row [B, U+1] as
carry, and inside each frame the label chain as one cumulative logsumexp
over u after an exclusive cumsum of the label scores, differentiated by
autograd. The finite NEG_INF (-1e30) and the soft -3e4 mask of label
transitions past a row's target length are JAX's: with -inf, or with
-1e30 in the cumsum, ``logcumsumexp`` and the cumsum give inf - inf = NaN
gradients. A row with feat_length 0 gives the value of feat_length 1
(finite), as in JAX; callers mask such rows.

The CPU tests use this version; on the card ``ops/rnnt_cuda.py`` runs the
lattice kernels and ``chip_smoke.py`` holds them against this one.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
SOFT_NEG = -3.0e4


def lattice_scores(logits: torch.Tensor, targets: torch.Tensor, target_lengths: torch.Tensor,
                   blank_id: int):
    """logits [B, T, U+1, V] -> (blank [B, T, U+1], label [B, T, U]) fp32
    log-probs: the fp32 log-softmax over V, the blank column and the
    targets' column (ids clipped to [0, V))."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    if targets.shape[1] != U:
        raise ValueError(f"targets U={targets.shape[1]} != logits U+1-1={U}")
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank = lp[..., blank_id]
    tgt = targets.long().clamp(0, V - 1)
    label = torch.gather(lp[:, :, :U, :], 3, tgt[:, None, :, None].expand(B, T, U, 1))[..., 0]
    return blank, label


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def lattice_nll(blank: torch.Tensor, label: torch.Tensor, feat_lengths: torch.Tensor,
                target_lengths: torch.Tensor) -> torch.Tensor:
    """blank [B, T, U+1], label [B, T, U] fp32 log-probs -> the per-row
    negative log-likelihood [B] (JAX's frame scan)."""
    B, T, U1 = blank.shape
    U = U1 - 1
    dev = blank.device
    u_ids = torch.arange(U, device=dev)
    lab = torch.where((u_ids[None, :] < target_lengths[:, None])[:, None, :], label,
                      torch.full((), SOFT_NEG, device=dev))
    alpha = torch.full((B, U1), NEG_INF, device=dev)
    alpha[:, 0] = 0.0
    zero = torch.zeros((B, 1), device=dev)
    betas = []
    for t in range(T):
        # alpha = base(u) entering frame t; the label chain unrolls to one
        # cumulative logsumexp: A_t(u) = c[u] + logcumsumexp_u(base - c)
        c = torch.cat([zero, torch.cumsum(lab[:, t], dim=1)], dim=1)
        beta = c + torch.logcumsumexp(alpha - c, dim=1)
        alpha = torch.where((t < feat_lengths)[:, None], beta + blank[:, t], alpha)
        betas.append(beta)
    betas = torch.stack(betas, dim=1)                                   # [B, T, U+1]
    last = (feat_lengths.long() - 1).clamp(min=0)
    ar = torch.arange(B, device=dev)
    u_last = target_lengths.long().clamp(0, U)
    return -(betas[ar, last, u_last] + blank[ar, last, u_last])


def rnnt_loss(logits: torch.Tensor, feat_lengths: torch.Tensor, targets: torch.Tensor,
              target_lengths: torch.Tensor, *, blank_id: int,
              reduction: str = "mean") -> torch.Tensor:
    """logits [B, T, U+1, V] (unnormalized joint outputs), feat_lengths [B],
    targets [B, U] (padding past target_lengths ignored), target_lengths
    [B] <= U -> -log P(y | x): [B] for "none", a scalar for "mean" / "sum"
    (over the batch; no per-length normalization)."""
    blank, label = lattice_scores(logits, targets, target_lengths, blank_id)
    return reduce_loss(lattice_nll(blank, label, feat_lengths, target_lengths), reduction)
