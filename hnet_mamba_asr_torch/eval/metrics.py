"""Word errors for the trainer's inline validation WER, counterpart of
``word_errors`` in ``hnet_mamba_asr_tpu/eval/metrics.py`` (the port keeps
its own copy): the Levenshtein distance between the word sequences, with a
two-row DP."""
from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Plain Levenshtein distance (substitution, deletion, insertion cost 1)."""
    if not ref or not hyp:
        return len(ref) + len(hyp)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def word_errors(hyp: str, ref: str) -> tuple[int, int]:
    """(word edits, number of reference words)."""
    rw = ref.split()
    return edit_distance(rw, hyp.split()), len(rw)
