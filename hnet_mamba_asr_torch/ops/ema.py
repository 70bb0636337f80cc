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
- ``ema_stream``: the recurrence over one block of a stream, from a carried
  state (JAX's ``models/streaming.py::_ema_stream``); the plain version of
  the kernel's carried form (``ops/ema_cuda.py::ema_stream_cuda``).

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


def ema_stream(z: torch.Tensor, p: torch.Tensor, n_real: torch.Tensor, carry: dict,
               p_clamp: float = 1e-4):
    """The recurrence over a compacted block z [B, E, D], p [B, E] fp32,
    from ``carry`` = {"ema": [B, D] fp32, "has": [B] bool} -> (zbar [B, E, D]
    in z's dtype, the new carry).

    Rows at or past ``n_real[b]`` are padding: exact no-ops that emit the
    carry. A row whose ``has`` is false takes its first real row verbatim
    (zbar_0 = z_0, the stream's first chunk); ``has`` turns true at a real
    row. P is clamped as in ``ema_smooth``; the state is fp32."""
    pc = p.float().clamp(p_clamp, 1.0 - p_clamp)
    zf = z.float()
    ema, has = carry["ema"].float(), carry["has"].bool()
    n_real = torch.as_tensor(n_real, device=z.device).reshape(-1).expand(z.shape[0])
    outs = []
    for t in range(z.shape[1]):
        real = (t < n_real)[:, None]
        upd = torch.where(has[:, None], pc[:, t, None] * zf[:, t]
                          + (1.0 - pc[:, t, None]) * ema, zf[:, t])
        ema = torch.where(real, upd, ema)
        has = has | real[:, 0]
        outs.append(ema)
    out = torch.stack(outs, dim=1) if outs else zf
    return out.to(z.dtype), {"ema": ema, "has": has}
