"""H-Net dynamic chunking: router, ratio loss, chunk and dechunk.

Counterpart of ``hnet_mamba_asr_tpu/models/hnet_chunk.py`` (Hwang, Wang &
Gu, arXiv:2507.07955). A sequence of encoder frames x [B, L, D] is
compressed at learned boundaries and later expanded:

    router:   p_t = 1/2 (1 - cos(W_q x_t, W_k x_{t-1})),  b_t = 1[p_t >= 0.5],
              p_1 == 1 (the first frame is always a boundary); causal.
    ratio:    L_ratio = N/(N-1) [ (N-1) F G + (1-F)(1-G) ],  F = mean b (hard),
              G = mean p (soft); fp32; 0 at N = 1.
    chunk:    kept frames go to slots membership = max(cumsum(b) - 1, 0).
    dechunk:  EMA-smooth the compressed stream with the kept frames' P
              (``ops/ema_cuda.py``), gather back by membership, then the
              confidence STE c_t = p^b (1-p)^(1-b): forward factor 1,
              gradient proportional to c.

Where the port departs from the JAX package's TPU form. JAX keeps the
compressed buffer at M = L slots, because XLA needs static shapes, and
scatters by a one-hot [B, L, L] matmul. Here the scatter is an exact index
scatter (each kept frame owns one slot; the others go to a slot past the
end that is cut off) and the buffer is trimmed to ``compressed_slots``: the
batch's largest count rounded up to 64 (the SSD kernel's chunk), at most L.
That costs one read of the counts by the host per chunk level. Slots at or
past a row's count are inert in both packages (the EMA is causal, the Mamba
stacks are length-aware, and no frame gathers them), so valid slots and
frames are unchanged; pad slots hold zeros and P = 0.

N = 1 is the identity: no router parameters, no ratio loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from hnet_mamba_asr_torch.models.mamba2 import dense
from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda

SLOT_MULTIPLE = 64              # the SSD kernel's chunk length


class ChunkOutput(NamedTuple):
    z: torch.Tensor              # [B, M, D]  compressed vectors
    z_mask: torch.Tensor         # [B, M]     True where a real chunk
    p: torch.Tensor              # [B, L]     soft boundary probabilities
    b: torch.Tensor              # [B, L]     hard boundary indicators {0., 1.}
    membership: torch.Tensor     # [B, L]     chunk slot of each fine frame
    ratio_loss: torch.Tensor     # scalar     0.0 at N = 1
    kept_fraction: torch.Tensor  # scalar     realized mean keep fraction


def identity_chunk(x: torch.Tensor, mask: torch.Tensor | None) -> ChunkOutput:
    """The shared N=1 passthrough: every frame is its own boundary."""
    B, L, _ = x.shape
    ones = torch.ones(B, L, dtype=x.dtype, device=x.device)
    if mask is not None:
        ones = ones * mask.to(x.dtype)
        z_mask = mask
    else:
        z_mask = torch.ones(B, L, dtype=torch.bool, device=x.device)
    memb = torch.arange(L, dtype=torch.int32, device=x.device)[None].expand(B, L)
    return ChunkOutput(z=x, z_mask=z_mask, p=ones, b=ones, membership=memb,
                       ratio_loss=torch.zeros((), device=x.device),
                       kept_fraction=torch.ones((), device=x.device))


def compressed_slots(counts: torch.Tensor, L: int) -> int:
    """Slots of the compressed buffer: the largest of ``counts`` rounded up
    to SLOT_MULTIPLE, at most L (one device-to-host read)."""
    top = max(int(counts.max()) if counts.numel() else 0, 1)
    return min(L, -(-top // SLOT_MULTIPLE) * SLOT_MULTIPLE)


def scatter_to_slots(values: torch.Tensor, membership: torch.Tensor, keep: torch.Tensor,
                     M: int) -> torch.Tensor:
    """Kept rows of values [B, L, D] (or [B, L]) into their slots of a
    zeroed [B, M, D] (or [B, M]): an index scatter, each kept frame to its
    own slot, the others to slot M, which is cut off."""
    squeeze = values.dim() == 2
    if squeeze:
        values = values[..., None]
    B, _, D = values.shape
    idx = torch.where(keep, membership, M).to(torch.int64)
    out = values.new_zeros(B, M + 1, D).scatter(1, idx[..., None].expand(-1, -1, D), values)
    out = out[:, :M]
    return out[..., 0] if squeeze else out


def gather_slots(z: torch.Tensor, membership: torch.Tensor) -> torch.Tensor:
    """z [B, M, D] -> [B, L, D]: each frame takes its slot's vector."""
    idx = membership.to(torch.int64)[..., None].expand(-1, -1, z.shape[-1])
    return torch.gather(z, 1, idx)


class RoutingModule(nn.Module):
    """Cosine-dissimilarity boundary router. W_q and W_k have no bias and
    start as the identity, so that cos(q, k) means something from step 0;
    they are computed in the model dtype, the cosine in fp32."""

    def __init__(self, d_model: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.W_q = skip_init(nn.Linear, d_model, d_model, bias=False)
        self.W_k = skip_init(nn.Linear, d_model, d_model, bias=False)
        with torch.no_grad():
            self.W_q.weight.copy_(torch.eye(d_model))
            self.W_k.weight.copy_(torch.eye(d_model))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        q = dense(x, self.W_q, self.dtype).float()
        k_prev = torch.roll(dense(x, self.W_k, self.dtype), 1, dims=1).float()  # k_{t-1}
        # the clamp sits inside the sqrt: the norm has an infinite gradient
        # at 0, and a zero frame (an empty slot feeding a Type B stage-2
        # router) would give 0 * inf = NaN in the backward
        sq = (q * q).sum(-1) * (k_prev * k_prev).sum(-1)
        cos = (q * k_prev).sum(-1) / torch.sqrt(sq.clamp(min=self.eps ** 2))
        p = 0.5 * (1.0 - cos)
        p = torch.cat([torch.ones_like(p[:, :1]), p[:, 1:]], dim=1)   # first frame
        p = p.clamp(0.0, 1.0)
        b = (p >= 0.5).to(p.dtype)
        if mask is not None:
            m = mask.to(p.dtype)
            p, b = p * m, b * m
        return p, b


def ratio_loss(p: torch.Tensor, b: torch.Tensor, N: float,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Steers the mean keep fraction toward 1/N; 0 at N == 1. fp32 sums."""
    if N == 1:
        return torch.zeros((), device=p.device)
    pf, bf = p.float(), b.float()
    if mask is None:
        F, G = bf.mean(), pf.mean()
    else:
        m = mask.float()
        denom = m.sum().clamp(min=1.0)
        F, G = (bf * m).sum() / denom, (pf * m).sum() / denom
    coef = N / (N - 1.0)
    return coef * ((N - 1.0) * F * G + (1.0 - F) * (1.0 - G))


class DynamicChunker(nn.Module):
    """One H-Net dynamic-chunking level; ``router`` exists only at N > 1."""

    def __init__(self, d_model: int, N: float = 1, ema_smoothing: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if N < 1:
            raise ValueError(f"N must be >= 1, got {N}")
        self.N, self.ema_smoothing = N, ema_smoothing
        self.identity = N == 1
        self.router = None if self.identity else RoutingModule(d_model, dtype=dtype)

    def chunk(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> ChunkOutput:
        B, L, _ = x.shape
        if self.identity:
            return identity_chunk(x, mask)
        p, b = self.router(x, mask)
        rl = ratio_loss(p, b, self.N, mask)
        keep = b > 0.5
        memb = (torch.cumsum(keep.to(torch.int32), dim=1) - 1).clamp(min=0)
        counts = keep.sum(dim=1)
        M = compressed_slots(counts, L)
        z = scatter_to_slots(x, memb, keep, M)
        z_mask = torch.arange(M, device=x.device)[None, :] < counts[:, None]
        valid = mask.sum() if mask is not None else torch.tensor(B * L, device=x.device)
        kept = keep.sum().float() / valid.float().clamp(min=1.0)
        return ChunkOutput(z=z, z_mask=z_mask, p=p, b=b, membership=memb, ratio_loss=rl,
                           kept_fraction=kept)

    def dechunk(self, z_proc: torch.Tensor, co: ChunkOutput) -> torch.Tensor:
        """Paper order Eq. 5 -> 8 -> 9: EMA at chunk rate, gather back,
        confidence STE last (forward factor c + (1 - c), as JAX computes it;
        gradient proportional to c)."""
        if self.identity:
            return z_proc
        keep = co.b > 0.5
        if self.ema_smoothing:
            P = scatter_to_slots(co.p, co.membership, keep, z_proc.shape[1])   # [B, M]
            z_proc = ema_cuda(z_proc, P)
        x_up = gather_slots(z_proc, co.membership)                           # Eq. 8
        c = torch.where(keep, co.p, 1.0 - co.p)
        ste = (c + (1.0 - c).detach())[..., None]                           # Eq. 9
        return x_up * ste.to(x_up.dtype)

    def forward(self, x, mask=None):
        return self.chunk(x, mask)
