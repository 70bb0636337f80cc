"""AED head: Transformer decoder with QK-RMSNorm attention, counterpart of
``hnet_mamba_asr_tpu/models/aed.py``: the teacher-forced training forward
and the KV-cached incremental decode.

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
length and row masks.

Decoding keeps, per layer, the self-attention K/V ring [R, cap, H, dh] and
the memory K/V projected once (``init_cache``). ``decode_start`` /
``decode_step`` are the beam's interface: each step gathers every row's ring
from its parent row, writes the new token's K/V at ``pos`` and returns fp32
next-token log-probs with bos and pad at -1e9. ``greedy_decode`` runs the
same step in a loop, eos-filled after a row ends. As in the JAX head,
``greedy_decode`` zeroes the pad row's embedding and ``decode_step`` does
not, and the positional encoding is sliced at ``pos``. The GEMMs of the
decode path run in blocks of ``DECODE_ROWS`` rows (``models/mamba2.py::dense``),
and the beams' and the greedy decode's steps attend one utterance's rows at
a time over its own keys (``decode_groups``), so that a beam's scores do not
depend on the batch.

With ``moe_experts`` > 0 every layer's FFN is the routed ``MoEFFN``
(``models/moe.py``); the forward routes only the tokens of ``token_mask``
(``ys_in != pad`` when none is given, as in JAX) and appends each layer's
(aux, dropped) to the ``moe_stats`` list a caller passes. A decode step
routes every row, as JAX's does; where capacity drops tokens, a row's
result depends on the rows routed beside it, by design.

Under tensor parallelism (``mp``, ``parallel/model_parallel.py``) q, k and
v are column-split by heads (the QK RMSNorm is per head: no collective),
``out_proj`` and ``linear2`` are row-split and their fp32 partial products
summed over the ranks before the bias and the cast, ``linear1`` is
column-split; the inputs of the column-split GEMMs (the LayerNorms'
outputs, the memory before the cross-attention's k / v) pass
``copy_to_model``, and so do the QK norms' gains, which every head shares.
The decode caches hold the rank's heads. Dropout on the
attention weights and on the FFN's hidden layer draws the whole tensor and
keeps the rank's heads or columns, so that tp trains the model one process
trains.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.mamba2 import dense, dense_w, new_linear, row_partial
from hnet_mamba_asr_torch.models.mamba_block import LN_EPS, layer_norm
from hnet_mamba_asr_torch.models.moe import MoEFFN
from hnet_mamba_asr_torch.parallel.collectives import batch_sum, row_slice
from hnet_mamba_asr_torch.parallel.model_parallel import column_row_plan

NEG_INF = -1e9
# the row block of every decode GEMM (models/mamba2.py::dense): the beam's
# rows and the memory's (utterances x frames) change with the batch, and
# cuBLAS picks its GEMM kernel, and with it the summation order, by the row
# count; blocks of one size keep a row's result the same alone and batched
DECODE_ROWS = 256
# a grouped decode attention reads keys in multiples of this (decode_groups)
KEY_BLOCK = 64


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            cols: tuple[int, int, int] | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate); the identity without a generator (eval). ``cols`` =
    (dim, full, start): ``x`` holds [start, start + its size) of a tensor
    ``full`` wide along ``dim`` (a tp rank's heads or columns), and the draw
    is the whole tensor's."""
    if generator is None or rate <= 0.0:
        return x
    shape = list(x.shape)
    if cols is not None:
        shape[cols[0]] = cols[1]
    part = row_slice()
    if part is None:
        keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    else:                       # the global batch's draw, this rank's rows
        rank, count = part
        B = shape[0]
        draw = torch.rand([B * count] + shape[1:], generator=generator, device=x.device)
        keep = draw[rank * B:(rank + 1) * B] >= rate
    if cols is not None:
        keep = keep.narrow(cols[0], cols[2], x.shape[cols[0]])
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def add_sos_eos(ys: torch.Tensor, ys_lens: torch.Tensor, bos_id: int, eos_id: int,
                pad_id: int):
    """bare [B, U] -> (ys_in = [bos, y..], ys_out = [y.., eos], lens + 1);
    entries past a row's length become pad."""
    B, U = ys.shape
    valid = torch.arange(U, device=ys.device)[None, :] < ys_lens[:, None]
    ys_clean = torch.where(valid, ys, pad_id)
    ys_in = torch.full((B, U + 1), pad_id, dtype=ys.dtype, device=ys.device)
    ys_in[:, 0] = bos_id
    ys_in[:, 1:] = ys_clean
    ys_out = torch.full((B, U + 1), pad_id, dtype=ys.dtype, device=ys.device)
    ys_out[:, :U] = ys_clean
    ys_out[torch.arange(B, device=ys.device), ys_lens.long()] = eos_id
    return ys_in, ys_out, ys_lens + 1


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
        self.mp = None                       # a tp Plane (parallel/model_parallel.py)

    def tp_plan(self, tp: int, prefix: str = "") -> dict:
        """q, k and v split by heads (weight rows and bias), out_proj by the
        same heads' columns."""
        return column_row_plan(prefix, ("q_proj", "k_proj", "v_proj"), ("out_proj",),
                               self.n_heads, tp, self.d_model // self.n_heads)

    @property
    def heads(self) -> int:
        """The heads this module computes per shard: H, or H / tp."""
        return self.n_heads // (self.mp.size if self.mp is not None else 1)

    def _lin(self, name: str, s: int | None):
        """(weight, bias) of a column-split projection at shard ``s``."""
        layer = getattr(self, name)
        if self.mp is None or s is None:
            return layer.weight, layer.bias
        return (self.mp.take(layer.weight, f"{name}.weight", s),
                self.mp.take(layer.bias, f"{name}.bias", s))

    def _rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (n * g).to(self.dtype)

    def project_q(self, query, rows: int = 0, s: int | None = None,
                  gain: torch.Tensor | None = None) -> torch.Tensor:
        B, Tq, _ = query.shape
        q = dense_w(query, *self._lin("q_proj", s), self.dtype, row_block=rows)
        return self._rms(q.reshape(B, Tq, self.heads, -1), self.q_g if gain is None else gain)

    def project_kv(self, key, value, rows: int = 0, s: int | None = None,
                   gain: torch.Tensor | None = None):
        B, Tk, _ = key.shape
        k = dense_w(key, *self._lin("k_proj", s), self.dtype, row_block=rows)
        v = dense_w(value, *self._lin("v_proj", s), self.dtype, row_block=rows)
        return (self._rms(k.reshape(B, Tk, self.heads, -1), self.k_g if gain is None else gain),
                v.reshape(B, Tk, self.heads, -1))

    def mix(self, q, k, v, attn_mask=None, key_padding_mask=None,
            generator: torch.Generator | None = None, s: int | None = None) -> torch.Tensor:
        """q [B,Tq,H,dh] (RMS'd), k/v [B,Tk,H,dh] (k RMS'd) -> the heads'
        weighted values [B,Tq,H dh], before the output projection; ``s``:
        the tp shard whose heads these are (this rank's by default)."""
        B, Tq = q.shape[0], q.shape[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
        if key_padding_mask is not None:                 # [B, Tk] True = pad
            logits = logits + torch.where(key_padding_mask, NEG_INF, 0.0)[:, None, None, :]
        if attn_mask is not None:                        # [Tq, Tk] additive
            logits = logits + attn_mask[None, None]
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        cols = None
        if self.mp is not None:
            shard = self.mp.rank if s is None else s
            cols = (1, self.n_heads, shard * self.heads)
        w = dropout(w, self.dropout, generator, cols)
        return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, -1)

    def project_out(self, out, rows: int = 0) -> torch.Tensor:
        """The output projection of ``mix``'s heads; under tp the ranks'
        fp32 partial products summed, then the bias and the cast."""
        if self.mp is None:
            return dense(out, self.out_proj, self.dtype, row_block=rows)
        return self._sum_out([row_partial(out, self.out_proj.weight, self.dtype, rows)])

    def _sum_out(self, parts: list) -> torch.Tensor:
        return (self.mp.reduce(parts) + self.out_proj.bias.to(self.dtype).float()).to(self.dtype)

    def attend(self, q, k, v, attn_mask=None, key_padding_mask=None,
               generator: torch.Generator | None = None, rows: int = 0) -> torch.Tensor:
        """``mix`` then the output projection -> [B,Tq,d]; ``rows``: the
        GEMM's row block (``models/mamba2.py::dense``)."""
        out = self.mix(q, k, v, attn_mask, key_padding_mask, generator)
        return self.project_out(out, rows)

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.mp is not None:
            return self._forward_tp(query, key, value, attn_mask, key_padding_mask, generator)
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        return self.attend(q, k, v, attn_mask=attn_mask, key_padding_mask=key_padding_mask,
                           generator=generator)


    def _forward_tp(self, query, key, value, attn_mask, key_padding_mask, generator):
        mp = self.mp
        qc = mp.fan(query)
        kc = qc if key is query else mp.fan(key)
        vc = kc if value is key else mp.fan(value)
        # one gain for every head: its gradient sums the shards'
        gq, gk = mp.fan(self.q_g), mp.fan(self.k_g)
        parts = []
        for i, s in enumerate(mp.each_shard(generator)):
            k, v = self.project_kv(kc[i], vc[i], s=s, gain=gk[i])
            out = self.mix(self.project_q(qc[i], s=s, gain=gq[i]), k, v, attn_mask,
                           key_padding_mask, generator, s)
            parts.append(row_partial(out, mp.take(self.out_proj.weight, "out_proj.weight", s),
                                     self.dtype))
        return self._sum_out(parts)


class DecoderLayerQKNorm(nn.Module):
    """Pre-LN decoder layer: self-attn -> cross-attn -> GELU (tanh) FFN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float,
                 dtype: torch.dtype = torch.float32, generator=None, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dropout, self.dtype, self.d_ff = dropout, dtype, d_ff
        self.self_attn = MHAQKNorm(d_model, n_heads, dropout, dtype=dtype, generator=generator)
        self.cross_attn = MHAQKNorm(d_model, n_heads, dropout, dtype=dtype,
                                    generator=generator)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d_model, eps=LN_EPS)
                                              for _ in range(3))
        if moe_experts > 0:
            self.moe = MoEFFN(d_model, d_ff, moe_experts, moe_top_k, moe_capacity_factor,
                              dtype, generator)
        else:
            self.moe = None
            self.linear1 = new_linear(d_model, d_ff, True, generator)
            self.linear2 = new_linear(d_ff, d_model, True, generator)
        self.mp = None              # a tp Plane of the FFN (parallel/model_parallel.py)

    def tp_plan(self, tp: int, prefix: str = "") -> dict | None:
        """The dense FFN's hidden layer by columns (an MoE FFN is ep's)."""
        if self.moe is not None:
            return None
        return column_row_plan(prefix, ("linear1",), ("linear2",), self.d_ff, tp)

    def _ffn(self, x, generator=None, rows: int = 0, token_mask=None,
             moe_stats: list | None = None) -> torch.Tensor:
        cd, rate = self.dtype, self.dropout
        h = layer_norm(x, self.norm3, cd)
        if self.moe is not None:
            y, aux, dropped = self.moe(h, token_mask)
            if moe_stats is not None:
                moe_stats.append((aux, dropped))
            return x + dropout(y, rate, generator)
        if self.mp is not None:
            return x + dropout(self._ffn_tp(h, generator, rows), rate, generator)
        ff = dropout(F.gelu(dense(h, self.linear1, cd, row_block=rows), approximate="tanh"),
                     rate, generator)
        return x + dropout(dense(ff, self.linear2, cd, row_block=rows), rate, generator)

    def _ffn_tp(self, h, generator, rows: int) -> torch.Tensor:
        """The FFN on the shards of ``mp``: linear1's columns, linear2's rows."""
        mp, cd = self.mp, self.dtype
        hc = mp.fan(h)
        parts = []
        for i, s in enumerate(mp.each_shard(generator)):
            w1 = mp.take(self.linear1.weight, "linear1.weight", s)
            ff = F.gelu(dense_w(hc[i], w1, mp.take(self.linear1.bias, "linear1.bias", s), cd,
                                row_block=rows), approximate="tanh")
            ff = dropout(ff, self.dropout, generator, (ff.dim() - 1, self.d_ff, s * w1.shape[0]))
            parts.append(row_partial(ff, mp.take(self.linear2.weight, "linear2.weight", s), cd,
                                     rows))
        return (mp.reduce(parts) + self.linear2.bias.to(cd).float()).to(cd)

    def forward(self, x, memory, tgt_mask, memory_key_padding_mask,
                generator: torch.Generator | None = None, token_mask=None,
                moe_stats: list | None = None) -> torch.Tensor:
        cd, rate = self.dtype, self.dropout
        h = layer_norm(x, self.norm1, cd)
        x = x + dropout(self.self_attn(h, h, h, attn_mask=tgt_mask, generator=generator),
                        rate, generator)
        h = layer_norm(x, self.norm2, cd)
        x = x + dropout(self.cross_attn(h, memory, memory,
                                        key_padding_mask=memory_key_padding_mask,
                                        generator=generator), rate, generator)
        return self._ffn(x, generator, token_mask=token_mask, moe_stats=moe_stats)

    # ---- KV-cached incremental decode ---------------------------------------
    def init_cache(self, memory: torch.Tensor, cap: int) -> dict:
        """Self-attention K/V rings [B, cap, H, dh] (zeros) and the memory K/V
        projected once."""
        B = memory.shape[0]
        H = self.self_attn.heads                         # the rank's heads under tp
        dh = self.self_attn.d_model // self.self_attn.n_heads
        mem_k, mem_v = self.cross_attn.project_kv(memory, memory, rows=DECODE_ROWS)
        zeros = torch.zeros(B, cap, H, dh, dtype=self.dtype, device=memory.device)
        return {"self_k": zeros, "self_v": zeros.clone(), "mem_k": mem_k, "mem_v": mem_v}

    def step(self, x_t, cache: dict, pos: int, memory_key_padding_mask, groups=None):
        """One position: x_t [B, 1, d] -> (y_t [B, 1, d], cache); the new K/V
        are written into the cache's rings at ``pos``. ``groups`` (see
        ``decode_groups``) runs both attentions one group of rows at a time
        over that group's keys only."""
        cd = self.dtype
        h = layer_norm(x_t, self.norm1, cd)
        k_new, v_new = self.self_attn.project_kv(h, h, rows=DECODE_ROWS)
        cache["self_k"][:, pos] = k_new[:, 0]
        cache["self_v"][:, pos] = v_new[:, 0]
        cap = cache["self_k"].shape[1]
        kpm_self = (torch.arange(cap, device=x_t.device) > pos)[None, :].expand(
            x_t.shape[0], cap)                           # future slots masked
        q = self.self_attn.project_q(h, rows=DECODE_ROWS)
        self_groups = None if groups is None else [(a, b, key_slots(pos + 1, cap))
                                                   for a, b, _ in groups]
        x_t = x_t + _attend_groups(self.self_attn, q, cache["self_k"], cache["self_v"],
                                   kpm_self, self_groups)
        h = layer_norm(x_t, self.norm2, cd)
        q = self.cross_attn.project_q(h, rows=DECODE_ROWS)
        x_t = x_t + _attend_groups(self.cross_attn, q, cache["mem_k"], cache["mem_v"],
                                   memory_key_padding_mask, groups)
        return self._ffn(x_t, rows=DECODE_ROWS), cache


def key_slots(valid: int, available: int) -> int:
    """The keys an attention call reads: ``valid`` rounded up to a multiple
    of ``KEY_BLOCK``, at most ``available``."""
    return min(available, -(-valid // KEY_BLOCK) * KEY_BLOCK)


def decode_groups(lengths, rows_per_group: int) -> list[tuple[int, int, int]]:
    """(first row, end row, memory keys) of each utterance's rows, for
    ``decode_step``: utterance i owns rows [i * rows_per_group, (i + 1) *
    rows_per_group) and reads its length rounded up to ``KEY_BLOCK`` memory
    frames, which ``decode_start``'s padded memory always holds: the count
    does not depend on the batch's longest utterance."""
    return [(i * rows_per_group, (i + 1) * rows_per_group, key_slots(int(n), 1 << 30))
            for i, n in enumerate(lengths)]


def _attend_groups(mha: MHAQKNorm, q, k, v, key_padding_mask, groups) -> torch.Tensor:
    """``mha.attend`` over all rows at once, or its heads' mix one group of
    rows at a time over its first keys only (``decode_groups``), then one
    output projection (its row blocks keep it row-invariant). Per group,
    every shape depends on its own utterance alone (its rows, its length
    rounded up to KEY_BLOCK), so that the attention's batched products,
    whose kernels cuBLAS picks by shape, give a beam the same bits alone
    and batched."""
    if groups is None:
        return mha.attend(q, k, v, key_padding_mask=key_padding_mask, rows=DECODE_ROWS)
    out = torch.cat([mha.mix(q[a:b], k[a:b, :n], v[a:b, :n],
                             key_padding_mask=key_padding_mask[a:b, :n]) for a, b, n in groups])
    return mha.project_out(out, DECODE_ROWS)


class AEDHead(nn.Module):
    """Transformer-decoder head over the tokenizer's V-token vocabulary."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int = 6, n_heads: int = 4,
                 d_ff: int = 2048, dropout: float = 0.1, lsm_weight: float = 0.1,
                 bos_id: int = 1, eos_id: int = 2, pad_id: int = 3,
                 max_decode_len: int = 512, max_pe_len: int = 5000, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.moe_experts = moe_experts
        self.vocab_size, self.d_model = vocab_size, d_model
        self.lsm_weight, self.dtype = lsm_weight, dtype
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.max_decode_len = max_decode_len
        self.embed = nn.Embedding(vocab_size, d_model)
        with torch.no_grad():                            # flax Embed: N(0, 1/d)
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d_model), generator=generator)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_pe_len, d_model)),
                             persistent=False)
        self.layers = nn.ModuleList(
            DecoderLayerQKNorm(d_model, n_heads, d_ff, dropout, dtype, generator, moe_experts,
                               moe_top_k, moe_capacity_factor)
            for _ in range(n_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.out = new_linear(d_model, vocab_size, True, generator)

    def add_sos_eos(self, ys: torch.Tensor, ys_lens: torch.Tensor):
        """bare [B, U] -> (ys_in = [bos, y..], ys_out = [y.., eos], lens + 1)."""
        return add_sos_eos(ys, ys_lens, self.bos_id, self.eos_id, self.pad_id)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ys_in: torch.Tensor, generator: torch.Generator | None = None,
                token_mask: torch.Tensor | None = None,
                moe_stats: list | None = None) -> torch.Tensor:
        """memory [B, S, d], ys_in [B, T] -> logits [B, T, V] in the compute
        dtype; ``generator`` turns dropout on (training). MoE layers route the
        tokens of ``token_mask`` (default: ys_in != pad) and append their
        (aux, dropped) to ``moe_stats``."""
        mem = memory.to(self.dtype)
        emb = self.embed(ys_in).to(self.dtype) * math.sqrt(self.d_model)
        emb = torch.where((ys_in == self.pad_id)[..., None], 0.0, emb)
        x = (emb.float() + self.pe[None, :ys_in.shape[1]]).to(self.dtype)
        tmask = causal_mask(ys_in.shape[1], ys_in.device)
        kpm = pad_mask(memory_lengths, mem.shape[1])
        if token_mask is None and self.moe_experts > 0:
            token_mask = ys_in != self.pad_id            # routing skips pad slots
        for layer in self.layers:
            x = layer(x, mem, tmask, kpm, generator=generator, token_mask=token_mask,
                      moe_stats=moe_stats)
        return dense(layer_norm(x, self.final_norm, self.dtype), self.out, self.dtype)

    # ---- beam-facing incremental decode ----------------------------------------
    def _embed_step(self, tokens: torch.Tensor, pos: int, zero_pad: bool) -> torch.Tensor:
        emb = self.embed(tokens[:, None]).to(self.dtype) * math.sqrt(self.d_model)
        if zero_pad:
            emb = torch.where((tokens[:, None] == self.pad_id)[..., None], 0.0, emb)
        return (emb.float() + self.pe[pos:pos + 1][None]).to(self.dtype)

    def _step_logits(self, x: torch.Tensor) -> torch.Tensor:
        """[R, 1, d] -> fp32 next-token logits [R, V], bos and pad at -1e9."""
        logits = dense(layer_norm(x, self.final_norm, self.dtype), self.out, self.dtype,
                       row_block=DECODE_ROWS)[:, 0].float()
        logits[:, self.bos_id] = NEG_INF
        logits[:, self.pad_id] = NEG_INF
        return logits

    def decode_start(self, memory: torch.Tensor, memory_lengths: torch.Tensor, cap: int):
        """Per-layer caches and the memory padding mask for ``decode_step``.
        The memory is padded (masked) to a ``KEY_BLOCK`` multiple of frames,
        so that ``decode_groups`` reads the same keys alone and batched."""
        mem = memory.to(self.dtype)
        mem = F.pad(mem, (0, 0, 0, key_slots(mem.shape[1], 1 << 30) - mem.shape[1]))
        kpm = pad_mask(memory_lengths, mem.shape[1])
        return [layer.init_cache(mem, cap) for layer in self.layers], kpm

    def decode_step(self, caches, kpm, parents: torch.Tensor, tokens: torch.Tensor, pos: int,
                    groups=None):
        """One label-synchronous step for R rows: gather each row's
        self-attention rings from its parent row, append ``tokens`` at
        ``pos``; -> (next-token log-probs [R, V] fp32, the new caches).
        ``groups`` (``decode_groups``): attend one utterance's rows at a
        time, so that a beam's scores do not depend on the batch."""
        gathered = [dict(c, self_k=c["self_k"][parents], self_v=c["self_v"][parents])
                    for c in caches]
        x = self._embed_step(tokens, pos, zero_pad=False)
        for layer, cache in zip(self.layers, gathered):
            x, cache = layer.step(x, cache, pos, kpm, groups)
        return torch.log_softmax(self._step_logits(x), dim=-1), gathered

    @torch.no_grad()
    def greedy_decode(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                      max_len: int | None = None) -> torch.Tensor:
        """KV-cached greedy decode: ids [B, cap], each row eos-filled after
        its first eos (``strip_hypothesis`` cuts it on the host). Each step
        attends one utterance at a time (``decode_groups``), so that a
        request's ids do not depend on the batch."""
        cap = self.max_decode_len if max_len is None else int(max_len)
        B = memory.shape[0]
        caches, kpm = self.decode_start(memory, memory_lengths, cap + 1)
        groups = decode_groups(memory_lengths.tolist(), 1)
        tok = torch.full((B,), self.bos_id, dtype=torch.long, device=memory.device)
        finished = torch.zeros(B, dtype=torch.bool, device=memory.device)
        out = []
        for t in range(cap):
            x = self._embed_step(tok, t, zero_pad=True)
            for layer, cache in zip(self.layers, caches):
                x, _ = layer.step(x, cache, t, kpm, groups)
            nxt = torch.argmax(self._step_logits(x), dim=-1)
            nxt = torch.where(finished, self.eos_id, nxt)
            finished = finished | (nxt == self.eos_id)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor,
                         target_lengths: torch.Tensor, lsm_weight: float,
                         row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Label-smoothed CE over [B, T, V] vs [B, T] in fp32; positions >= length
    and rows outside ``row_mask`` contribute neither loss nor count; the
    mean is over the global batch's tokens."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    on, off = 1.0 - lsm_weight, lsm_weight / (V - 1)
    tgt_logp = torch.gather(logp, -1, target[..., None].long())[..., 0]
    nll = -(off * logp.sum(-1) + (on - off) * tgt_logp)
    mask = ~pad_mask(target_lengths, target.shape[1])
    if row_mask is not None:
        mask = mask & row_mask[:, None]
    # the token count of the global batch (``batch_sum``: over the ranks that
    # split its rows, else this batch's)
    return batch_sum((nll * mask).sum()) / batch_sum(mask.sum()).clamp(min=1)


def strip_hypothesis(ids, eos_id: int) -> list[int]:
    """Host-side: cut a decoded row at its first eos."""
    out = []
    for i in ids:
        i = int(i)
        if i == eos_id:
            break
        out.append(i)
    return out
