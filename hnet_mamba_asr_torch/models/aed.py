"""AED head: Transformer decoder with QK-RMSNorm attention, counterpart of
``hnet_mamba_asr_tpu/models/aed.py``, for the teacher-forced training
forward.

Pre-LN decoder layers (self-attention -> cross-attention -> FFN) whose
attentions RMS-normalize Q and K per head (eps 1e-6) before the scaled dot
product. The FFN's GELU is the tanh approximation (flax's default; torch's
default is erf). LayerNorms use flax's eps of 1e-6 and fp32 statistics.
Parameters keep the JAX names and are stored in fp32; the compute dtype is
the model's. Attention is two plain matmuls with additive masks (-1e9), as
in the JAX head. Dropout draws from the generator the caller passes, so
that it is a function of the training step.

Targets are bare token ids in [0, V); ``add_sos_eos`` wraps them as decoder
input [bos, y..] and target [y.., eos] (bos 1, eos 2, pad 3).
``label_smoothing_loss`` is the fp32 label-smoothed cross-entropy with
length and row masks. Decoding (greedy, beam) and the MoE FFN are not
ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.mamba2 import dense, new_linear
from hnet_mamba_asr_torch.models.mamba_block import LN_EPS, layer_norm

NEG_INF = -1e9


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    if d_model % 2:
        raise ValueError("d_model must be even for sinusoidal PE")
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def causal_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] additive mask: NEG_INF above the diagonal."""
    keep = torch.ones(size, size, dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, NEG_INF)


def pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, max_len] bool, True at PADDED positions."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate); the identity without a generator (eval)."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class MHAQKNorm(nn.Module):
    """Multi-head attention with per-head RMSNorm on Q and K."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.d_model, self.n_heads, self.dropout, self.eps = d_model, n_heads, dropout, eps
        self.dtype = dtype
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            new_linear(d_model, d_model, True, generator) for _ in range(4))
        dh = d_model // n_heads
        self.q_g = nn.Parameter(torch.ones(dh))
        self.k_g = nn.Parameter(torch.ones(dh))

    def _rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (n * g).to(self.dtype)

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, Tq, _ = query.shape
        Tk = key.shape[1]
        q = self._rms(dense(query, self.q_proj, self.dtype).reshape(B, Tq, self.n_heads, -1),
                      self.q_g)
        k = self._rms(dense(key, self.k_proj, self.dtype).reshape(B, Tk, self.n_heads, -1),
                      self.k_g)
        v = dense(value, self.v_proj, self.dtype).reshape(B, Tk, self.n_heads, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
        if key_padding_mask is not None:                 # [B, Tk] True = pad
            logits = logits + torch.where(key_padding_mask, NEG_INF, 0.0)[:, None, None, :]
        if attn_mask is not None:                        # [Tq, Tk] additive
            logits = logits + attn_mask[None, None]
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        w = dropout(w, self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, self.d_model)
        return dense(out, self.out_proj, self.dtype)


class DecoderLayerQKNorm(nn.Module):
    """Pre-LN decoder layer: self-attn -> cross-attn -> GELU (tanh) FFN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.self_attn = MHAQKNorm(d_model, n_heads, dropout, dtype=dtype, generator=generator)
        self.cross_attn = MHAQKNorm(d_model, n_heads, dropout, dtype=dtype,
                                    generator=generator)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d_model, eps=LN_EPS)
                                              for _ in range(3))
        self.linear1 = new_linear(d_model, d_ff, True, generator)
        self.linear2 = new_linear(d_ff, d_model, True, generator)

    def forward(self, x, memory, tgt_mask, memory_key_padding_mask,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cd, rate = self.dtype, self.dropout
        h = layer_norm(x, self.norm1, cd)
        x = x + dropout(self.self_attn(h, h, h, attn_mask=tgt_mask, generator=generator),
                        rate, generator)
        h = layer_norm(x, self.norm2, cd)
        x = x + dropout(self.cross_attn(h, memory, memory,
                                        key_padding_mask=memory_key_padding_mask,
                                        generator=generator), rate, generator)
        h = layer_norm(x, self.norm3, cd)
        ff = dropout(F.gelu(dense(h, self.linear1, cd), approximate="tanh"), rate, generator)
        return x + dropout(dense(ff, self.linear2, cd), rate, generator)


class AEDHead(nn.Module):
    """Transformer-decoder head over the tokenizer's V-token vocabulary."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int = 6, n_heads: int = 4,
                 d_ff: int = 2048, dropout: float = 0.1, lsm_weight: float = 0.1,
                 bos_id: int = 1, eos_id: int = 2, pad_id: int = 3,
                 max_pe_len: int = 5000, moe_experts: int = 0,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError("the MoE FFN of the AED head (aed_conf.moe) is not "
                                      "ported; models/moe.py comes in a later slice")
        self.vocab_size, self.d_model = vocab_size, d_model
        self.lsm_weight, self.dtype = lsm_weight, dtype
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.embed = nn.Embedding(vocab_size, d_model)
        with torch.no_grad():                            # flax Embed: N(0, 1/d)
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d_model), generator=generator)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_pe_len, d_model)),
                             persistent=False)
        self.layers = nn.ModuleList(
            DecoderLayerQKNorm(d_model, n_heads, d_ff, dropout, dtype, generator)
            for _ in range(n_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.out = new_linear(d_model, vocab_size, True, generator)

    def add_sos_eos(self, ys: torch.Tensor, ys_lens: torch.Tensor):
        """bare [B, U] -> (ys_in = [bos, y..], ys_out = [y.., eos], lens + 1)."""
        B, U = ys.shape
        valid = torch.arange(U, device=ys.device)[None, :] < ys_lens[:, None]
        ys_clean = torch.where(valid, ys, self.pad_id)
        ys_in = torch.full((B, U + 1), self.pad_id, dtype=ys.dtype, device=ys.device)
        ys_in[:, 0] = self.bos_id
        ys_in[:, 1:] = ys_clean
        ys_out = torch.full((B, U + 1), self.pad_id, dtype=ys.dtype, device=ys.device)
        ys_out[:, :U] = ys_clean
        ys_out[torch.arange(B, device=ys.device), ys_lens.long()] = self.eos_id
        return ys_in, ys_out, ys_lens + 1

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ys_in: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """memory [B, S, d], ys_in [B, T] -> logits [B, T, V] in the compute
        dtype; ``generator`` turns dropout on (training)."""
        mem = memory.to(self.dtype)
        emb = self.embed(ys_in).to(self.dtype) * math.sqrt(self.d_model)
        emb = torch.where((ys_in == self.pad_id)[..., None], 0.0, emb)
        x = (emb.float() + self.pe[None, :ys_in.shape[1]]).to(self.dtype)
        tmask = causal_mask(ys_in.shape[1], ys_in.device)
        kpm = pad_mask(memory_lengths, mem.shape[1])
        for layer in self.layers:
            x = layer(x, mem, tmask, kpm, generator=generator)
        return dense(layer_norm(x, self.final_norm, self.dtype), self.out, self.dtype)


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor,
                         target_lengths: torch.Tensor, lsm_weight: float,
                         row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Label-smoothed CE over [B, T, V] vs [B, T] in fp32; positions >= length
    and rows outside ``row_mask`` contribute neither loss nor count."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    on, off = 1.0 - lsm_weight, lsm_weight / (V - 1)
    tgt_logp = torch.gather(logp, -1, target[..., None].long())[..., 0]
    nll = -(off * logp.sum(-1) + (on - off) * tgt_logp)
    mask = ~pad_mask(target_lengths, target.shape[1])
    if row_mask is not None:
        mask = mask & row_mask[:, None]
    return (nll * mask).sum() / mask.sum().clamp(min=1)
