"""Causal EMA smoother of the H-Net dechunk (paper Eq. 5), in plain PyTorch.

Counterpart of ``hnet_mamba_asr_tpu/ops/ema.py``. Over the compressed
sequence, with per-slot probabilities P:

    zbar_t = P_t * z_t + (1 - P_t) * zbar_{t-1}        (zbar_0 = z_0)

- ``ema_smooth``: the form the JAX package computes, one causal matmul per
  row. With S = cumsum(log(1 - P)) (S_0 = 0), s_0 = z_0 and s_j = P_j z_j,
  zbar_t = sum_{j<=t} exp(S_t - S_j) s_j. The weights are built in fp32 and
  cast to z's dtype, and the matmul runs in z's dtype, as in JAX. It is the
  plain version of the Hopper kernel in ``ops/ema_cuda.py``, which computes
  the recurrence instead.
- ``ema_smooth_sequential``: the recurrence as a loop, the tests' oracle.

P is clamped to [p_clamp, 1 - p_clamp] by ``torch.clamp``, whose gradient is
zero outside the range: a clamp that passed the gradient through would
amplify it by up to 1 / (1 - p) at a saturated boundary. Future positions
are masked to -inf before the exp, so that no overflow reaches a gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ema_smooth(z: torch.Tensor, p: torch.Tensor, p_clamp: float = 1e-4) -> torch.Tensor:
    """z [B, M, D], p [B, M] fp32 -> the EMA-smoothed [B, M, D] in z's dtype."""
    M = z.shape[1]
    if M == 1:
        return z
    pc = p.clamp(p_clamp, 1.0 - p_clamp)
    src = torch.cat([z[:, :1], pc[:, 1:, None].to(z.dtype) * z[:, 1:]], dim=1)
    log_keep = torch.log1p(-pc[:, 1:].float())                       # log(1 - P), fp32
    S = F.pad(torch.cumsum(log_keep, dim=1), (1, 0))                 # [B, M], S_0 = 0
    logw = S[:, :, None] - S[:, None, :]                             # S_t - S_j
    causal = torch.ones(M, M, dtype=torch.bool, device=z.device).tril()
    W = torch.exp(logw.masked_fill(~causal, float("-inf"))).to(z.dtype)
    return torch.einsum("bts,bsd->btd", W, src)


def ema_smooth_sequential(z: torch.Tensor, p: torch.Tensor,
                          p_clamp: float = 1e-4) -> torch.Tensor:
    """The literal recurrence in fp32, one step per slot (tests' oracle)."""
    pc = p.clamp(p_clamp, 1.0 - p_clamp).float()
    zf = z.float()
    out = [zf[:, 0]]
    for t in range(1, z.shape[1]):
        out.append(pc[:, t, None] * zf[:, t] + (1.0 - pc[:, t, None]) * out[-1])
    return torch.stack(out, dim=1).to(z.dtype)
