"""The Mamba-H-Net encoder sandwich (Type A one-stage, Type B two-stage),
counterpart of ``hnet_mamba_asr_tpu/models/encoder.py``.

conv subsample x4 (100 -> 25 Hz) -> enc Mamba stack (d_outer) -> [chunk ->
proj_in -> main Mamba stack (d_main, compressed rate) -> proj_out ->
dechunk] -> residual ``x_enc + x_dech`` (the fine-detail bypass) -> dec
Mamba stack. Type B nests two sqrt(N) chunk levels with mid stacks at
d_main. At N = 1 every chunker is the identity and the encoder is pure
bidirectional Mamba (the no-chunk control).

Under tensor parallelism (``mp``, Type A) ``proj_in`` is column-split and
gathered (the main stack's LayerNorm needs the whole d_main) and
``proj_out`` row-split over each rank's slice of its replicated input, then
summed over the ranks; the subsampling, the router and the EMA dechunk stay
replicated: their inputs are equal on every rank.

Returns per-stage boundaries, chunk embeddings (on the trimmed buffer of
``models/hnet_chunk.py``: compare valid slots only) and kept fractions, and
the summed ratio loss.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.fixed_pool import FixedPoolChunker
from hnet_mamba_asr_torch.models.hnet_chunk import DynamicChunker
from hnet_mamba_asr_torch.models.mamba2 import dense, dense_w, lecun_normal_, new_linear, row_partial
from hnet_mamba_asr_torch.models.mamba_block import MambaStack
from hnet_mamba_asr_torch.parallel.model_parallel import column_row_plan

CHUNKERS = {"dynamic": DynamicChunker, "fixed": FixedPoolChunker}


def build_chunker(kind: str, d_model: int, N, ema_smoothing: bool = True,
                  dtype: torch.dtype = torch.float32):
    kind = str(kind).lower()
    if kind not in CHUNKERS:
        raise ValueError(f"unknown chunker {kind!r}; choices: {sorted(CHUNKERS)}")
    return CHUNKERS[kind](d_model=d_model, N=N, ema_smoothing=ema_smoothing, dtype=dtype)


class EncoderOutput(NamedTuple):
    features: torch.Tensor      # [B, L0, d_outer] frame-rate output
    lengths: torch.Tensor       # [B] valid frames after subsampling
    ratio_loss: torch.Tensor    # scalar, summed over stages (0 at N=1)
    boundaries: tuple           # per stage: (p [B,L], b [B,L])
    chunk_embeddings: tuple     # per stage: z [B, M, d]
    kept_fractions: tuple       # per stage: scalar realized keep fraction


def subsampled_length(lengths):
    """Valid length after two k=3, s=2 VALID convs: ((L-1)//2 - 1)//2."""
    n = ((lengths - 1) // 2 - 1) // 2
    return n.clamp(min=0) if torch.is_tensor(n) else np.maximum(n, 0)


def lengths_to_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _new_conv(c_in: int, c_out: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, kernel_size=3, stride=2)
    lecun_normal_(conv.weight, 9 * c_in, generator)
    return conv


class ConvSubsampling4(nn.Module):
    """x4 time downsample: two Conv(k=3, s=2, VALID) + ReLU, flatten F x C ->
    Linear. The flatten runs over [B, T, F, C], the JAX layout, so JAX
    weights load unscrambled.

    Weights are drawn as flax draws them (lecun-normal), but the three
    biases as torch draws them, U(+-1/sqrt(fan_in)), as in the reference
    repo, not flax's zeros. With zero biases a frame that SpecAugment's time
    masks zero out leaves the subsampling as an all-zero vector and stays
    one through every block (LayerNorm, the Mamba mixer and the gated
    RMSNorm all map 0 to 0), while each block's backward scales its
    gradient by the norms' 1/sqrt(eps): ~1e5 per block, inf through the
    gate config's 20 blocks, so its first update is NaN (the JAX package's
    init does this). Non-zero biases give such a frame a non-constant
    vector from the start."""

    def __init__(self, n_mels: int, d_model: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _new_conv(1, d_model, generator)
        self.conv2 = _new_conv(d_model, d_model, generator)
        f_out = ((n_mels - 1) // 2 - 1) // 2
        self.proj = new_linear(f_out * d_model, d_model, True, generator)
        with torch.no_grad():
            for layer in (self.conv1, self.conv2, self.proj):
                bound = layer.weight[0].numel() ** -0.5
                layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        return self.frames(feats), subsampled_length(lengths)

    def frames(self, feats: torch.Tensor, dtype: torch.dtype | None = None,
               row_block: int = 0) -> torch.Tensor:
        """[B, T, F] -> [B, T', d] in ``dtype`` (the module's by default);
        ``row_block``: the projection's GEMM blocks (see dense())."""
        cd = self.dtype if dtype is None else dtype
        x = feats.to(cd)[:, None]                                   # [B, 1, T, F]
        for conv in (self.conv1, self.conv2):
            x = F.relu(F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=2))
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)             # [B, T, F*C]
        # a long reduction (F*C = 7296 at full width): see dense()
        return dense(x, self.proj, cd, row_multiple=1024, row_block=row_block)


class DCASREncoder(nn.Module):
    """Type A (one chunk level at factor N) or Type B (two sqrt(N) levels)."""

    def __init__(self, n_mels: int = 80, d_outer: int = 384, d_main: int = 512,
                 n_enc: int = 4, n_main: int = 12, n_dec: int = 4, n_mid: int = 4,
                 arch_type: str = "A", N: float = 1, bidirectional: bool = True,
                 hnet_ema: bool = True, chunker: str = "dynamic", d_state: int = 128,
                 headdim: int = 64, chunk_size: int = 256,
                 ssd_intra_dtype: str | None = None, ssd_out_compute_dtype: bool = False,
                 remat_policy: str = "full", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if arch_type not in ("A", "B"):
            raise ValueError(f"arch_type must be 'A' or 'B', got {arch_type!r}")
        self.arch_type = arch_type
        self.d_outer, self.d_main = d_outer, d_main
        self.bidirectional = bidirectional
        self.dtype = dtype
        stack_kw = dict(bidirectional=bidirectional, d_state=d_state, headdim=headdim,
                        chunk_size=chunk_size, ssd_intra_dtype=ssd_intra_dtype,
                        ssd_out_compute_dtype=ssd_out_compute_dtype,
                        remat_policy=remat_policy, dtype=dtype, generator=generator)
        self.subsample = ConvSubsampling4(n_mels, d_outer, dtype, generator)
        self.enc = MambaStack(n_enc, d_outer, **stack_kw)
        if arch_type == "A":
            self.chunk = build_chunker(chunker, d_outer, N, hnet_ema, dtype)
            self.proj_in = new_linear(d_outer, d_main, True, generator)
            self.main = MambaStack(n_main, d_main, **stack_kw)
            self.proj_out = new_linear(d_main, d_outer, True, generator)
        else:                                          # Type B: two sqrt(N) stages
            nb = math.sqrt(N)
            self.chunk1 = build_chunker(chunker, d_outer, nb, hnet_ema, dtype)
            self.proj1_in = new_linear(d_outer, d_main, True, generator)
            self.mid = MambaStack(n_mid, d_main, **stack_kw)
            self.chunk2 = build_chunker(chunker, d_main, nb, hnet_ema, dtype)
            self.main = MambaStack(n_main, d_main, **stack_kw)
            self.mid_dec = MambaStack(n_mid, d_main, **stack_kw)
            self.proj1_out = new_linear(d_main, d_outer, True, generator)
        self.dec = MambaStack(n_dec, d_outer, **stack_kw)
        self.mp = None                       # a tp Plane (parallel/model_parallel.py)

    def tp_plan(self, tp: int, prefix: str = "") -> dict | None:
        """Type A's proj_in by columns and proj_out by rows (Type B's
        proj1_in / proj1_out stay whole: JAX's rule names neither)."""
        if self.arch_type != "A":
            return None
        return column_row_plan(prefix, ("proj_in",), ("proj_out",), self.d_main, tp)

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
                main=None) -> EncoderOutput:
        """``main``: a callable (z, lengths) -> the main stack's output, in
        place of ``self.main`` (Type A; ``parallel/pipeline.py``'s stages)."""
        x, lengths = self.subsample(feats, feat_lengths)
        mask = lengths_to_mask(lengths, x.shape[1])
        x_enc = self.enc(x, lengths)
        if self.arch_type == "A":
            return self._forward_a(x_enc, mask, lengths, main or self.main)
        if main is not None:
            raise ValueError("a main-stack override takes a Type A encoder")
        return self._forward_b(x_enc, mask, lengths)

    def _forward_a(self, x_enc, mask, lengths, main) -> EncoderOutput:
        co = self.chunk.chunk(x_enc, mask)
        z = self._proj_in(co.z)
        z = main(z, co.z_mask.sum(dim=1))
        x_dech = self.chunk.dechunk(self._proj_out(z), co)
        x_out = self.dec(x_enc + x_dech, lengths)               # fine-detail bypass
        return EncoderOutput(x_out, lengths, co.ratio_loss, ((co.p, co.b),),
                             (co.z,), (co.kept_fraction,))

    def _proj_in(self, z: torch.Tensor) -> torch.Tensor:
        mp, cd = self.mp, self.dtype
        if mp is None:
            return dense(z, self.proj_in, cd)
        return mp.gather([dense_w(zc, mp.take(self.proj_in.weight, "proj_in.weight", s),
                                  mp.take(self.proj_in.bias, "proj_in.bias", s), cd)
                          for zc, s in zip(mp.fan(z), mp.shards)])

    def _proj_out(self, z: torch.Tensor) -> torch.Tensor:
        mp, cd = self.mp, self.dtype
        if mp is None:
            return dense(z, self.proj_out, cd)
        width = self.d_main // mp.size
        parts = [row_partial(zc[..., s * width:(s + 1) * width],
                             mp.take(self.proj_out.weight, "proj_out.weight", s), cd)
                 for zc, s in zip(mp.fan(z), mp.shards)]
        return (mp.reduce(parts) + self.proj_out.bias.to(cd).float()).to(cd)

    def _forward_b(self, x_enc, mask, lengths) -> EncoderOutput:
        co1 = self.chunk1.chunk(x_enc, mask)                    # frames -> units
        units = co1.z_mask.sum(dim=1)
        z1 = self.mid(dense(co1.z, self.proj1_in, self.dtype), units)
        co2 = self.chunk2.chunk(z1, co1.z_mask)                 # units -> words
        z2 = self.main(co2.z, co2.z_mask.sum(dim=1))
        z1_dec = self.mid_dec(z1 + self.chunk2.dechunk(z2, co2), units)
        x_dech = self.chunk1.dechunk(dense(z1_dec, self.proj1_out, self.dtype), co1)
        x_out = self.dec(x_enc + x_dech, lengths)
        return EncoderOutput(x_out, lengths, co1.ratio_loss + co2.ratio_loss,
                             ((co1.p, co1.b), (co2.p, co2.b)), (co1.z, co2.z),
                             (co1.kept_fraction, co2.kept_fraction))
