"""Decoder-only causal Transformer LM for the +LM decode cells, counterpart of
``hnet_mamba_asr_tpu/models/lm.py``.

Trained on its own over the ASR decoder's BPE vocabulary, so that decode
fuses log-probs over the same tokens. Pre-LN blocks (LayerNorm -> causal
multi-head attention -> residual; LayerNorm -> tanh-GELU FFN -> residual),
no QK-norm and no final norm, sinusoidal positions, pad embeddings zeroed.
The attention is flax's ``MultiHeadDotProductAttention``: q, k, v
projections with per-head biases, q scaled by 1/sqrt(dh), masked logits set
to the dtype's lowest value, softmax, then the output projection over (H,
dh). Its kernels keep the head axes: ``query`` / ``key`` / ``value`` weights
are [H, dh, d] and ``out``'s is [d, H, dh] (``convert.py`` carries flax's
[d, H, dh] and [H, dh, d] across). Loss input is [bos, w..], target
[w.., eos], label-smoothed cross-entropy in fp32, as the AED head's.

``decoders/lm_scorer.py`` gives every scoring call one of a few fixed
shapes, so that a prefix's score does not depend on the batch.

With ``moe_experts`` > 0 each block's FFN is the routed ``MoEFFN``
(``models/moe.py``); the loss routes the scored positions of the real rows
only and returns the layers' (aux, dropped) beside it (``moe_stats``).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.aed import (
    add_sos_eos, dropout, label_smoothing_loss, pad_mask, sinusoidal_pe)
from hnet_mamba_asr_torch.models.mamba2 import dense, lecun_normal_, new_linear
from hnet_mamba_asr_torch.models.mamba_block import LN_EPS, layer_norm
from hnet_mamba_asr_torch.models.moe import MoEFFN
from hnet_mamba_asr_torch.parallel.collectives import batch_sum


class HeadsDense(nn.Module):
    """flax ``DenseGeneral`` onto or from the (H, dh) head axes: ``weight``
    [H, dh, d] with ``bias`` [H, dh] (``into_heads``), or [d, H, dh] with
    bias [d]."""

    def __init__(self, d_model: int, n_heads: int, into_heads: bool, generator=None):
        super().__init__()
        dh = d_model // n_heads
        self.d_model, self.into_heads = d_model, into_heads
        shape = (n_heads, dh, d_model) if into_heads else (d_model, n_heads, dh)
        self.weight = nn.Parameter(torch.empty(shape))
        lecun_normal_(self.weight, d_model, generator)
        self.bias = nn.Parameter(torch.zeros((n_heads, dh) if into_heads else (d_model,)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, rows: int = 0) -> torch.Tensor:
        """``rows``: the GEMM's row block (``models/mamba2.py::dense``)."""
        w = (self.weight.reshape(-1, self.d_model) if self.into_heads
             else self.weight.reshape(self.d_model, -1))
        return dense(x, SimpleNamespace(weight=w, bias=self.bias.reshape(-1)), dtype,
                     row_block=rows)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with a boolean causal mask."""

    def __init__(self, d_model: int, n_heads: int, dropout_rate: float,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.n_heads, self.dropout, self.dtype = n_heads, dropout_rate, dtype
        self.query, self.key, self.value = (HeadsDense(d_model, n_heads, True, generator)
                                            for _ in range(3))
        self.out = HeadsDense(d_model, n_heads, False, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, generator=None) -> torch.Tensor:
        B, T, d = x.shape
        H, cd = self.n_heads, self.dtype
        q, k, v = (m(x, cd).reshape(B, T, H, -1) for m in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=cd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1).to(cd)
        w = dropout(w, self.dropout, generator)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, d)
        return self.out(o, cd)


class LMBlock(nn.Module):
    """Pre-LN block: LN -> attention -> +res; LN -> GELU FFN -> +res."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout_rate: float,
                 dtype: torch.dtype = torch.float32, generator=None, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dropout, self.dtype = dropout_rate, dtype
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = SelfAttention(d_model, n_heads, dropout_rate, dtype, generator)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        if moe_experts > 0:
            self.moe = MoEFFN(d_model, d_ff, moe_experts, moe_top_k, moe_capacity_factor,
                              dtype, generator)
        else:
            self.moe = None
            self.linear1 = new_linear(d_model, d_ff, True, generator)
            self.linear2 = new_linear(d_ff, d_model, True, generator)

    def forward(self, x, mask, generator=None, token_mask=None,
                moe_stats: list | None = None) -> torch.Tensor:
        cd, rate = self.dtype, self.dropout
        h = layer_norm(x, self.norm1, cd)
        x = x + dropout(self.self_attn(h, mask, generator), rate, generator)
        h = layer_norm(x, self.norm2, cd)
        if self.moe is not None:
            ff, aux, dropped = self.moe(h, token_mask)
            if moe_stats is not None:
                moe_stats.append((aux, dropped))
        else:
            ff = dropout(F.gelu(dense(h, self.linear1, cd), approximate="tanh"), rate,
                         generator)
            ff = dense(ff, self.linear2, cd)
        return x + dropout(ff, rate, generator)


class TransformerLM(nn.Module):
    """ids [B, T] -> next-token logits [B, T, V] (causal self-attention)."""

    def __init__(self, vocab_size: int, d_model: int = 512, n_layers: int = 16,
                 n_heads: int = 8, d_ff: int = 2048, dropout: float = 0.1,
                 lsm_weight: float = 0.1, bos_id: int = 1, eos_id: int = 2, pad_id: int = 3,
                 max_pe_len: int = 5000, moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.moe_experts = moe_experts
        self.vocab_size, self.d_model = vocab_size, d_model
        self.lsm_weight, self.dtype = lsm_weight, dtype
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.embed = nn.Embedding(vocab_size, d_model)
        with torch.no_grad():                            # flax Embed: N(0, 1/d)
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d_model), generator=generator)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_pe_len, d_model)),
                             persistent=False)
        self.blocks = nn.ModuleList(LMBlock(d_model, n_heads, d_ff, dropout, dtype, generator,
                                            moe_experts, moe_top_k, moe_capacity_factor)
                                    for _ in range(n_layers))
        self.out = new_linear(d_model, vocab_size, True, generator)

    def forward(self, ids: torch.Tensor, generator: torch.Generator | None = None,
                token_mask: torch.Tensor | None = None, moe_stats: list | None = None
                ) -> torch.Tensor:
        """ids [B, T] -> logits [B, T, V] in the compute dtype; ``generator``
        turns dropout on (training). MoE blocks route the tokens of
        ``token_mask`` (all by default, as in JAX) and append their (aux,
        dropped) to ``moe_stats``."""
        T = ids.shape[1]
        emb = self.embed(ids).to(self.dtype) * math.sqrt(self.d_model)
        emb = torch.where((ids == self.pad_id)[..., None], 0.0, emb)
        x = (emb.float() + self.pe[None, :T]).to(self.dtype)
        mask = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()[None, None]
        for block in self.blocks:
            x = block(x, mask, generator, token_mask, moe_stats)
        return dense(x, self.out, self.dtype)

    def loss(self, tokens: torch.Tensor, token_lengths: torch.Tensor,
             generator: torch.Generator | None = None,
             row_mask: torch.Tensor | None = None, moe_stats: list | None = None):
        """(label-smoothed CE over [w.., eos], next-token accuracy); padded
        batch rows (``row_mask`` False) count in neither, and MoE blocks route
        neither them nor the positions past a row's eos."""
        ys_in, ys_out, out_lens = add_sos_eos(tokens, token_lengths, self.bos_id,
                                              self.eos_id, self.pad_id)
        mask = ~pad_mask(out_lens, ys_out.shape[1])
        if row_mask is not None:
            mask = mask & row_mask[:, None]
        logits = self(ys_in, generator, mask if self.moe_experts > 0 else None, moe_stats)
        loss = label_smoothing_loss(logits, ys_out, out_lens, self.lsm_weight,
                                    row_mask=row_mask)
        acc = (batch_sum(((logits.argmax(-1) == ys_out) & mask).sum())
               / batch_sum(mask.sum()).clamp(min=1))
        return loss, acc
