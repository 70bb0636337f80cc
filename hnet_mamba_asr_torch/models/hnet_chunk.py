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

Streaming (``DynamicChunker.stream``, JAX's chunk stage of
``models/streaming.py``): a block of E frames is routed from the carried key
of the last real frame (``RoutingModule.step``), its kept frames go to the
front of an E-slot block by the same index scatter (``compact_block``; JAX
uses a one-hot matmul there), the inner stacks run on it with a count of
real slots per row, the EMA runs from its carried state
(``ops/ema_cuda.py::ema_stream_cuda``), and each frame gathers its slot, or
the carried EMA before the block's first boundary (``upsample_block``). In
fp32, as JAX streams.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from hnet_mamba_asr_torch.models.mamba2 import STREAM_ROWS, dense
from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda, ema_stream_cuda
from hnet_mamba_asr_torch.parallel.collectives import batch_sum

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


def compact_block(x: torch.Tensor, p: torch.Tensor, b: torch.Tensor):
    """A block's kept rows of x [B, E, D] and their p to the front of E
    slots (zeros after) -> (z [B, E, D], P [B, E], kept counts [B])."""
    keep = b > 0.5
    memb = (torch.cumsum(keep.to(torch.int32), dim=1) - 1).clamp(min=0)
    E = x.shape[1]
    return (scatter_to_slots(x, memb, keep, E), scatter_to_slots(p, memb, keep, E),
            keep.sum(dim=1))


def upsample_block(zbar: torch.Tensor, b: torch.Tensor, carry: dict) -> torch.Tensor:
    """Each frame of a block takes the EMA output [B, E, D] of its latest
    kept frame, or the carried EMA (zero before the stream's first) where
    the block has had no boundary yet. The STE factor is 1 at inference."""
    idx = torch.cumsum((b > 0.5).to(torch.int32), dim=1) - 1
    gathered = gather_slots(zbar, idx.clamp(min=0))
    prev = torch.where(carry["has"][:, None], carry["ema"], 0.0).to(zbar.dtype)
    return torch.where((idx >= 0)[..., None], gathered, prev[:, None, :])


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
            for w in (self.W_q.weight, self.W_k.weight):
                w.copy_(torch.eye(d_model, device=w.device))

    def _p(self, q: torch.Tensor, k_prev: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
        """Boundary probabilities 0.5 (1 - cos(q_t, k_{t-1})) in fp32,
        clamped to [0, 1]; 1 at frame 0 of the rows where ``first`` [B] (a
        stream's first frame, which has no k_{t-1})."""
        # the clamp sits inside the sqrt: the norm has an infinite gradient
        # at 0, and a zero frame (an empty slot feeding a Type B stage-2
        # router) would give 0 * inf = NaN in the backward
        sq = (q * q).sum(-1) * (k_prev * k_prev).sum(-1)
        cos = (q * k_prev).sum(-1) / torch.sqrt(sq.clamp(min=self.eps ** 2))
        p = 0.5 * (1.0 - cos)
        p0 = torch.where(first, 1.0, p[:, 0])
        return torch.cat([p0[:, None], p[:, 1:]], dim=1).clamp(0.0, 1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        q = dense(x, self.W_q, self.dtype).float()
        k_prev = torch.roll(dense(x, self.W_k, self.dtype), 1, dims=1).float()  # k_{t-1}
        p = self._p(q, k_prev, torch.ones_like(q[:, 0, 0], dtype=torch.bool))
        b = (p >= 0.5).to(p.dtype)
        if mask is not None:
            m = mask.to(p.dtype)
            p, b = p * m, b * m
        return p, b

    def step(self, x: torch.Tensor, n_real: torch.Tensor, state: dict):
        """Route one block x [B, E, D] of a stream, rows [0, n_real) real, from
        ``state`` = {"k_last": [B, D] W_k of the last real frame seen,
        "started": [B] bool} -> (p, b, the new state). The stream's first
        frame gets p = 1; a block's first frame reads the carried key."""
        f32 = torch.float32
        E = x.shape[1]
        q = dense(x, self.W_q, f32, row_block=STREAM_ROWS)
        k = dense(x, self.W_k, f32, row_block=STREAM_ROWS)
        k_prev = torch.cat([state["k_last"][:, None], k[:, :-1]], dim=1)
        real = (torch.arange(E, device=x.device)[None, :] < n_real[:, None]).to(f32)
        p = self._p(q, k_prev, ~state["started"]) * real
        b = (p >= 0.5).to(f32) * real
        last = k.gather(1, (n_real.long() - 1).clamp(min=0)[:, None, None].expand(
            -1, 1, k.shape[-1]))[:, 0]
        seen = n_real > 0
        return p, b, {"k_last": torch.where(seen[:, None], last, state["k_last"]),
                      "started": state["started"] | seen}


def ratio_loss(p: torch.Tensor, b: torch.Tensor, N: float,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Steers the mean keep fraction toward 1/N; 0 at N == 1. fp32 sums."""
    if N == 1:
        return torch.zeros((), device=p.device)
    pf, bf = p.float(), b.float()
    if mask is None:
        F, G = bf.mean(), pf.mean()
    else:
        # F and G are means over the global batch (batch_sum), before the
        # nonlinear loss is formed from them
        m = mask.float()
        denom = batch_sum(m.sum()).clamp(min=1.0)
        F, G = batch_sum((bf * m).sum()) / denom, batch_sum((pf * m).sum()) / denom
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
        kept = batch_sum(keep.sum().float()) / batch_sum(valid.float()).clamp(min=1.0)
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

    def stream(self, x: torch.Tensor, n_real: torch.Tensor, state: dict, inner):
        """One block of a stream through this level: route, compact, ``inner(z,
        kept counts)`` -> processed z, EMA from the carry, upsample. ``state``
        = {"router": ..., "ema": {"ema": [B, D] fp32, "has": [B] bool}} ->
        (x at the frame rate, the new state). At N > 1 with ``ema_smoothing``
        (``models/streaming.py::CausalStreamingEncoder`` checks both)."""
        p, b, router = self.router.step(x, n_real, state["router"])
        z, P, kept = compact_block(x, p, b)
        zbar, ema = ema_stream_cuda(inner(z, kept), P, kept, state["ema"])
        return upsample_block(zbar, b, state["ema"]).to(x.dtype), {"router": router, "ema": ema}

    def fresh_state(self, batch: int, d_model: int, device) -> dict:
        return {"router": {"k_last": torch.zeros(batch, d_model, device=device),
                           "started": torch.zeros(batch, dtype=torch.bool, device=device)},
                "ema": {"ema": torch.zeros(batch, d_model, device=device),
                        "has": torch.zeros(batch, dtype=torch.bool, device=device)}}

    def forward(self, x, mask=None):
        return self.chunk(x, mask)
