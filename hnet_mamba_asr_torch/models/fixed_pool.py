"""Fixed-stride pooling chunker, the "learned vs fixed" control, counterpart
of ``hnet_mamba_asr_tpu/models/fixed_pool.py``.

A drop-in for ``DynamicChunker`` at the same compression 1/N: boundaries sit
every N frames and each window of N frames is mean-pooled over its valid
frames (in fp32); no parameters, no ratio loss. It needs an integer stride:
Type A passes N, Type B sqrt(N), so fixed-pool Type B exists only at
perfect-square N. At stride 1 it is the identity.

The pooled buffer holds ``compressed_slots`` slots (the batch's largest
window count rounded up to 64, at most L) where JAX keeps L; windows fill
the first ceil(length / N) of them. The dechunk clamps each frame's window
to the buffer, which moves only frames past a row's length.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.hnet_chunk import (
    ChunkOutput, compressed_slots, gather_slots, identity_chunk)


class FixedPoolChunker(nn.Module):
    """Masked mean pooling over fixed windows of N frames."""

    def __init__(self, d_model: int, N: float = 1, ema_smoothing: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stride = int(round(float(N)))
        if abs(float(N) - stride) > 1e-6:
            raise ValueError(
                f"FixedPoolChunker needs an integer stride; got N={N!r}. "
                "Fixed-stride pooling has no fractional window — Type B fixed-pool "
                "is only defined at perfect-square N (so sqrt(N) is an integer).")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.stride = stride
        self.identity = stride == 1

    def chunk(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> ChunkOutput:
        B, L, D = x.shape
        if self.identity:
            return identity_chunk(x, mask)
        s = self.stride
        if mask is not None:
            lengths = mask.sum(dim=1)
            m = mask.float()
        else:
            lengths = torch.full((B,), L, dtype=torch.int64, device=x.device)
            m = torch.ones(B, L, device=x.device)
        n_win = -(-L // s)
        pad = n_win * s - L
        xm = F.pad(x.float() * m[..., None], (0, 0, 0, pad)).view(B, n_win, s, D)
        acc = xm.sum(dim=2)                                          # [B, n_win, D]
        cnt = F.pad(m, (0, pad)).view(B, n_win, s).sum(dim=2)        # [B, n_win]
        M = compressed_slots((cnt > 0).sum(dim=1), L)
        acc = F.pad(acc, (0, 0, 0, max(0, M - n_win)))[:, :M]
        cnt = F.pad(cnt, (0, max(0, M - n_win)))[:, :M]
        z = (acc / cnt.clamp(min=1.0)[..., None]).to(x.dtype)
        pos = torch.arange(L, device=x.device)
        memb = (pos // s).to(torch.int32)[None].expand(B, L)
        b = (pos % s == 0).to(x.dtype)[None] * m.to(x.dtype)
        nwin = ((lengths + s - 1) // s).clamp(min=1)
        kept = nwin.sum().float() / lengths.sum().float().clamp(min=1.0)
        return ChunkOutput(z=z, z_mask=cnt > 0, p=b, b=b, membership=memb,
                           ratio_loss=torch.zeros((), device=x.device), kept_fraction=kept)

    def dechunk(self, z_proc: torch.Tensor, co: ChunkOutput) -> torch.Tensor:
        """Each window's vector back over its frames (identity at stride 1)."""
        if self.identity:
            return z_proc
        return gather_slots(z_proc, co.membership.clamp(max=z_proc.shape[1] - 1))

    def forward(self, x, mask=None):
        return self.chunk(x, mask)
