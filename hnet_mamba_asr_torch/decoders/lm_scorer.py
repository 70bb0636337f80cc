"""CausalLMScorer: a causal LM behind the two decode-time interfaces,
counterpart of ``hnet_mamba_asr_tpu/decoders/lm_scorer.py``.

- ``next_logprobs(prefixes) -> [n, V]``: next-token log-softmax after
  bos + prefix, the first-pass shallow fusion of the CTC prefix beam;
- ``sequence_logprob(sequences) -> [n]``: the log-prob of each complete
  hypothesis including its terminal eos, the second-pass rescoring of the
  AED / joint n-best.

Summing ``next_logprobs`` step by step over the same tokens (plus the final
eos) equals ``sequence_logprob``.

Each call runs the LM on the model's device over whole prefixes, as the JAX
scorer does. Rows are grouped by the power-of-two bucket of their own
length (at least 8 positions) and sent in chunks of exactly ``ROWS`` rows,
padded, so that every GEMM has the same shape whatever else is being scored:
a prefix's score does not depend on the rest of the batch.
"""
from __future__ import annotations

import numpy as np
import torch

ROWS = 16                       # the rows of every LM call



def bucket(n: int, lo: int = 8) -> int:
    """The smallest power-of-two multiple of ``lo`` that is >= n."""
    b = lo
    while b < n:
        b *= 2
    return b


class CausalLMScorer:
    def __init__(self, lm_model, bos_id: int = 1, eos_id: int = 2, pad_id: int = 3):
        self.lm = lm_model
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size = lm_model.vocab_size

    @property
    def device(self) -> torch.device:
        return next(self.lm.parameters()).device

    def _chunks(self, lengths: list[int]):
        """(L, row indices) per call: rows grouped by the bucket of their own
        length, ``ROWS`` at a time."""
        groups: dict[int, list[int]] = {}
        for i, n in enumerate(lengths):
            groups.setdefault(bucket(n), []).append(i)
        for L in sorted(groups):
            idx = groups[L]
            for c in range(0, len(idx), ROWS):
                yield L, idx[c:c + ROWS]

    def _log_softmax(self, ids: np.ndarray) -> torch.Tensor:
        """ids [rows, L] -> fp32 log-softmax [rows, L, V] on the device."""
        t = torch.from_numpy(ids).to(self.device)
        return torch.log_softmax(self.lm(t).float(), dim=-1)

    # ---- first-pass fusion interface ------------------------------------------
    @torch.inference_mode()
    def next_logprobs(self, prefixes: list[list[int]]) -> np.ndarray:
        """[n, V]: log P(next | bos, prefix) for each ragged prefix."""
        lens = [len(p) + 1 for p in prefixes]                  # + bos
        order, parts = [], []
        for L, idx in self._chunks(lens):
            ids = np.full((ROWS, L), self.pad_id, dtype=np.int64)
            ids[:, 0] = self.bos_id
            last = np.zeros(ROWS, dtype=np.int64)
            for j, i in enumerate(idx):
                p = prefixes[i]
                if p:
                    ids[j, 1:1 + len(p)] = p
                last[j] = lens[i] - 1                          # causal: pad after is inert
            logp = self._log_softmax(ids)
            parts.append(logp[torch.arange(len(idx)), torch.from_numpy(last[:len(idx)])])
            order.extend(idx)
        out = np.empty((len(prefixes), self.vocab_size), np.float32)
        if parts:
            out[order] = torch.cat(parts).cpu().numpy()
        return out

    # ---- second-pass rescoring interface ---------------------------------------
    @torch.inference_mode()
    def sequence_logprob(self, sequences: list[list[int]]) -> np.ndarray:
        """[n]: sum_i log P(w_i | bos, w_<i) + log P(eos | bos, w) per sequence."""
        lens = [len(s) + 1 for s in sequences]                 # scored: tokens + eos
        order, parts = [], []
        for L, idx in self._chunks(lens):
            ys_in = np.full((ROWS, L), self.pad_id, dtype=np.int64)
            ys_out = np.full((ROWS, L), self.pad_id, dtype=np.int64)
            ys_in[:, 0] = self.bos_id
            n_scored = np.zeros(ROWS, dtype=np.int64)
            for j, i in enumerate(idx):
                s = sequences[i]
                k = len(s)
                if k:
                    ys_in[j, 1:1 + k] = s
                    ys_out[j, :k] = s
                ys_out[j, k] = self.eos_id
                n_scored[j] = lens[i]
            logp = self._log_softmax(ys_in)
            tgt = torch.gather(logp, -1, torch.from_numpy(ys_out).to(logp.device)[..., None])
            tgt = tgt[..., 0]
            mask = (np.arange(L)[None, :] < n_scored[:, None]).astype(np.float32)
            parts.append((tgt * torch.from_numpy(mask).to(tgt.device)).sum(-1)[:len(idx)])
            order.extend(idx)
        out = np.empty(len(sequences), np.float32)
        if parts:
            out[order] = torch.cat(parts).cpu().numpy()
        return out
