"""CTC head: linear projection to V+1 classes (blank at id V), counterpart of
``hnet_mamba_asr_tpu/models/ctc_head.py``. Greedy decode is the per-frame
argmax, then a host-side collapse of repeats and blanks."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from hnet_mamba_asr_torch.models.mamba2 import dense, new_linear


class CTCHead(nn.Module):
    """d_model -> vocab_size + 1 linear CTC head."""

    def __init__(self, d_model: int, vocab_size: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.proj = new_linear(d_model, vocab_size + 1, True, generator)

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def num_classes(self) -> int:
        return self.vocab_size + 1

    def forward(self, features: torch.Tensor, row_block: int = 0) -> torch.Tensor:
        """[B, L, d_model] -> logits [B, L, V+1] in the compute dtype
        (``row_block``: the GEMM's, see dense())."""
        # V+1 is odd (501 for bpe_500): see dense()
        return dense(features, self.proj, self.dtype, col_multiple=8, row_block=row_block)

    def log_probs(self, features: torch.Tensor) -> torch.Tensor:
        """fp32 log-softmax over classes."""
        return torch.log_softmax(self(features).float(), dim=-1)

    def frame_argmax(self, features: torch.Tensor, row_block: int = 0) -> torch.Tensor:
        """Per-frame top class incl. blank [B, L]: the raw CTC spikes."""
        return torch.argmax(self(features, row_block), dim=-1)


def ctc_greedy_collapse(frame_ids, blank_id: int) -> list[int]:
    """Collapse consecutive duplicates, then drop blanks (host-side).
    A blank between identical labels keeps them distinct (a _ a -> a a)."""
    out: list[int] = []
    prev = None
    for s in frame_ids:
        s = int(s)
        if s != prev:
            if s != blank_id:
                out.append(s)
            prev = s
    return out


def greedy_decode(frame_ids, feat_lengths, blank_id: int) -> list[list[int]]:
    """Frame argmax [B, L] + lengths -> bare-id lists per utterance."""
    ids = np.asarray(frame_ids)
    lens = np.asarray(feat_lengths)
    return [ctc_greedy_collapse(ids[i, :int(lens[i])], blank_id)
            for i in range(ids.shape[0])]
