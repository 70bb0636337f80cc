"""RNN-T (transducer) head with a stateless prediction network, counterpart
of ``hnet_mamba_asr_tpu/models/rnnt.py``.

The predictor embeds the last ``context`` emitted tokens (most recent first,
bos-filled) and projects their concatenation to the joint width; the joint
is tanh(enc_proj(memory) + pred_proj(history)) -> Dense(V+1), blank the last
class (id V), as in the CTC head. Training evaluates the joint over the
whole [B, T, U+1] lattice and hands its GEMM output, padded to ``OUT_COLS``
columns, with the number of classes to ``ops/rnnt_cuda.py`` (the loss
kernels on the card, which read the bf16 logits in place and return their
gradient in the same layout; the plain ``ops/rnnt_loss.py`` on the CPU).
Parameters keep the JAX names (``embed``, ``pred_proj``, ``enc_proj``,
``out``) and are stored in fp32; the compute dtype is the model's.

Greedy decode is frame-synchronous: per frame up to ``max_symbols`` joint
evaluations, each emitting its argmax while it is not blank, as JAX's
static unroll does (every round runs; rows that stopped are masked). The
decode GEMMs (``encode_features``, the predictor and the joint of a step)
run in blocks of ``DECODE_ROWS`` rows (``models/mamba2.py::dense``), so that
a request's ids do not depend on the batch. The beam searches are
``decoders/rnnt_decode.py`` (host) and ``decoders/device_rnnt_beam.py``
(device).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from hnet_mamba_asr_torch.models.aed import DECODE_ROWS
from hnet_mamba_asr_torch.models.mamba2 import dense, new_linear
from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda

# V+1 is odd (501 for bpe_500): the joint's output columns padded to a
# multiple of 8, as the CTC head's (models/mamba2.py::dense)
OUT_COLS = 8


class RNNTHead(nn.Module):
    """Transducer head over the shared V-token vocabulary (blank = V)."""

    def __init__(self, vocab_size: int, d_memory: int, d_pred: int = 256, d_joint: int = 512,
                 context: int = 2, max_symbols: int = 4, max_decode_len: int = 512,
                 bos_id: int = 1, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.vocab_size, self.d_pred, self.context = vocab_size, d_pred, context
        self.max_symbols, self.max_decode_len = max_symbols, max_decode_len
        self.bos_id, self.dtype = bos_id, dtype
        self.embed = nn.Embedding(vocab_size, d_pred)
        with torch.no_grad():                            # flax Embed: N(0, 1/d)
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d_pred), generator=generator)
        self.pred_proj = new_linear(context * d_pred, d_joint, True, generator)
        self.enc_proj = new_linear(d_memory, d_joint, True, generator)
        self.out = new_linear(d_joint, vocab_size + 1, True, generator)

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def num_classes(self) -> int:
        return self.vocab_size + 1

    # ---- prediction network --------------------------------------------------
    def _predict(self, hist: torch.Tensor, rows: int = 0) -> torch.Tensor:
        """hist [..., context] ids (most recent first, bos-filled) -> [...,
        d_joint] predictor features; ``rows``: the GEMM's row block."""
        emb = self.embed(hist.long().clamp(0, self.vocab_size - 1)).to(self.dtype)
        emb = emb.reshape(*hist.shape[:-1], self.context * self.d_pred)
        return dense(emb, self.pred_proj, self.dtype, row_block=rows)

    def _histories(self, targets: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
        """[B, U] labels -> [B, U+1, context] left-contexts per position
        (position u conditions on y_{u-1}, y_{u-2}, ...; bos before the first)."""
        B, U = targets.shape
        valid = torch.arange(U, device=targets.device)[None, :] < target_lengths[:, None]
        clean = torch.where(valid, targets.long(), self.bos_id)
        padded = torch.cat([torch.full((B, self.context), self.bos_id, dtype=torch.long,
                                       device=targets.device), clean], dim=1)
        # hist[u, j] = padded[u + C-1 - j]  (j = 0 is the most recent token)
        cols = (torch.arange(U + 1, device=targets.device)[:, None]
                + (self.context - 1 - torch.arange(self.context, device=targets.device))[None])
        return padded[:, cols]

    # ---- joint ----------------------------------------------------------------
    def _logits(self, x: torch.Tensor, rows: int = 0, padded: bool = False) -> torch.Tensor:
        return dense(torch.tanh(x), self.out, self.dtype, col_multiple=OUT_COLS,
                     row_block=rows, keep_pad=padded)

    def joint(self, enc_f: torch.Tensor, pred_f: torch.Tensor) -> torch.Tensor:
        """enc_f [B, T, J], pred_f [B, U+1, J] -> logits [B, T, U+1, V+1
        rounded up to OUT_COLS]: the GEMM's output, its pad columns (zeros)
        after the V+1 classes."""
        return self._logits(enc_f[:, :, None, :] + pred_f[:, None, :, :], padded=True)

    def loss(self, memory: torch.Tensor, memory_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor) -> torch.Tensor:
        """Per-row transducer NLL [B] (callers apply row_mask and any
        per-token normalization)."""
        enc_f = dense(memory.to(self.dtype), self.enc_proj, self.dtype)
        pred_f = self._predict(self._histories(targets, target_lengths))
        return rnnt_loss_cuda(self.joint(enc_f, pred_f), memory_lengths, targets,
                              target_lengths, blank_id=self.blank_id, reduction="none",
                              classes=self.num_classes)

    # ---- decode ------------------------------------------------------------------
    def encode_features(self, memory: torch.Tensor) -> torch.Tensor:
        """memory [B, T, d_memory] -> joint-space encoder features [B, T, J]
        (once per utterance; row-blocked)."""
        return dense(memory.to(self.dtype), self.enc_proj, self.dtype, row_block=DECODE_ROWS)

    def step_logits(self, enc_f_t: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
        """enc_f_t [R, J], hist [R, context] -> joint logits [R, V+1] in the
        compute dtype: one joint evaluation per row (row-blocked)."""
        return self._logits(enc_f_t + self._predict(hist, DECODE_ROWS), DECODE_ROWS)

    def step_logprobs(self, enc_f_t: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
        """-> fp32 log-probs [R, V+1]: the beams' expansion step."""
        return torch.log_softmax(self.step_logits(enc_f_t, hist).float(), dim=-1)

    @torch.no_grad()
    def greedy_decode(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                      hist: torch.Tensor | None = None, return_hist: bool = False):
        """Frame-synchronous greedy search -> (tokens [B, L], lengths [B]),
        L = min(max_decode_len, T * max_symbols).

        ``hist`` [B, context] carries the label history into this call and
        ``return_hist=True`` returns the updated history as well: with the
        stateless predictor, feeding the frames block by block with the
        history threaded through equals one pass."""
        B, T, _ = memory.shape
        dev = memory.device
        L = min(self.max_decode_len, T * self.max_symbols)
        enc_f = self.encode_features(memory)
        hist = (torch.full((B, self.context), self.bos_id, dtype=torch.long, device=dev)
                if hist is None else hist.long().to(dev))
        buf = torch.zeros((B, L), dtype=torch.long, device=dev)
        out_len = torch.zeros(B, dtype=torch.long, device=dev)
        ar = torch.arange(B, device=dev)
        t_real = torch.arange(T, device=dev)[None, :] < memory_lengths[:, None]
        for t in range(T):
            alive = t_real[:, t]
            for _ in range(self.max_symbols):
                tok = torch.argmax(self.step_logits(enc_f[:, t], hist), dim=-1)
                emit = alive & (tok != self.blank_id) & (out_len < L)
                slot = out_len.clamp(max=L - 1)
                buf[ar, slot] = torch.where(emit, tok, buf[ar, slot])
                out_len = out_len + emit.long()
                hist = torch.where(emit[:, None], torch.cat([tok[:, None], hist[:, :-1]], 1),
                                   hist)
                alive = alive & emit
        if return_hist:
            return buf, out_len, hist
        return buf, out_len


def rnnt_host_greedy(tokens, lengths) -> list[list[int]]:
    """Greedy output (tokens [B, L], lengths [B]) -> per-utterance id lists."""
    toks = np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens)
    lens = np.asarray(lengths.cpu() if torch.is_tensor(lengths) else lengths)
    return [toks[b, :int(lens[b])].tolist() for b in range(toks.shape[0])]
