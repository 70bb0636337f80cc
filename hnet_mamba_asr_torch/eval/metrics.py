"""ASR error metrics: WER / CER / TER with the substitution / deletion /
insertion split, counterpart of ``hnet_mamba_asr_tpu/eval/metrics.py`` (the
port keeps its own copy of the numpy path; the JAX package's optional C++
library is not ported).

Error rate = (S + D + I) / N over words, characters (spaces stripped) or
token ids, after the scoring normalization (lowercase, punctuation dropped
with apostrophes kept, whitespace collapsed). The DP runs a row at a time in
numpy; ``word_errors`` is the trainer's inline dev-WER unit.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

_NON_WORD = re.compile(r"[^\w\s']")


def normalize_text(s: str, lowercase: bool = True, remove_punct: bool = True) -> str:
    """Scoring normalization: lowercase, drop punctuation (apostrophes survive),
    collapse runs of whitespace."""
    if lowercase:
        s = s.lower()
    if remove_punct:
        s = _NON_WORD.sub(" ", s)
    return " ".join(s.split())


def _to_codes(ref: Sequence, hyp: Sequence) -> tuple[np.ndarray, np.ndarray]:
    """Map two unit sequences onto shared integer codes for vectorized DP."""
    table: dict = {}
    def enc(seq):
        out = np.empty(len(seq), dtype=np.int64)
        for i, u in enumerate(seq):
            out[i] = table.setdefault(u, len(table))
        return out
    return enc(list(ref)), enc(list(hyp))


def _dp_row(prev: np.ndarray, cost: np.ndarray, i: int, j_idx: np.ndarray) -> np.ndarray:
    """One Levenshtein DP row, fully vectorized.

    dp[i,j] = min(prev[j-1]+cost[j-1], prev[j]+1, dp[i,j-1]+1). The left
    (insertion) dependency has constant weight 1, so the recurrence linearizes
    to a min-plus prefix: row[j] = min_{k<=j}(base[k] + (j-k)) with
    base[0] = dp[i,0] = i and base[j>=1] = min(prev[j-1]+cost, prev[j]+1).
    """
    base = np.empty(prev.shape[0], dtype=np.int64)
    base[0] = i
    np.minimum(prev[:-1] + cost, prev[1:] + 1, out=base[1:])
    return np.minimum.accumulate(base - j_idx) + j_idx


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Plain Levenshtein distance, two-row numpy DP (no backtrace) — the fast
    path for inline validation WER."""
    r, h = _to_codes(ref, hyp)
    R, H = len(r), len(h)
    if R == 0 or H == 0:
        return R + H
    prev = np.arange(H + 1, dtype=np.int64)
    j_idx = np.arange(H + 1, dtype=np.int64)
    for i in range(1, R + 1):
        prev = _dp_row(prev, (h != r[i - 1]).astype(np.int64), i, j_idx)
    return int(prev[-1])


def levenshtein_counts(ref: Sequence, hyp: Sequence) -> tuple[int, int, int, int]:
    """Aligned (sub, del, ins, cor) via full DP + backtrace.

    Backtrace preference order is match > substitution > deletion > insertion,
    matching the reference alignment so S/D/I splits are comparable.
    Invariants: cor+sub+del == len(ref); cor+sub+ins == len(hyp);
    sub+del+ins == edit distance.
    """
    r, h = _to_codes(ref, hyp)
    R, H = len(r), len(h)
    dp = np.zeros((R + 1, H + 1), dtype=np.int64)
    dp[0, :] = np.arange(H + 1)
    j_idx = np.arange(H + 1, dtype=np.int64)
    for i in range(1, R + 1):
        dp[i] = _dp_row(dp[i - 1], (h != r[i - 1]).astype(np.int64), i, j_idx)
    i, j = R, H
    sub = dele = ins = cor = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and r[i - 1] == h[j - 1] and dp[i, j] == dp[i - 1, j - 1]:
            cor += 1; i -= 1; j -= 1
        elif i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + 1:
            sub += 1; i -= 1; j -= 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dele += 1; i -= 1
        else:
            ins += 1; j -= 1
    return sub, dele, ins, cor


@dataclass
class ErrorStats:
    """Accumulated error counts over utterances; rates are fractions (x100 for %)."""
    n_ref: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0
    cor: int = 0
    n_utt: int = 0
    n_correct: int = 0

    def add(self, ref: Sequence, hyp: Sequence) -> None:
        s, d, i, c = levenshtein_counts(ref, hyp)
        self.n_ref += len(ref)
        self.sub += s; self.dele += d; self.ins += i; self.cor += c
        self.n_utt += 1
        self.n_correct += int(list(ref) == list(hyp))

    @property
    def errors(self) -> int:
        return self.sub + self.dele + self.ins

    @property
    def er(self) -> float:
        return self.errors / max(1, self.n_ref)

    @property
    def sub_rate(self) -> float:
        return self.sub / max(1, self.n_ref)

    @property
    def del_rate(self) -> float:
        return self.dele / max(1, self.n_ref)

    @property
    def ins_rate(self) -> float:
        return self.ins / max(1, self.n_ref)

    @property
    def sentence_acc(self) -> float:
        return self.n_correct / max(1, self.n_utt)

    def as_dict(self, prefix: str = "wer") -> dict[str, float]:
        return {prefix: 100 * self.er, f"{prefix}_sub": 100 * self.sub_rate,
                f"{prefix}_del": 100 * self.del_rate, f"{prefix}_ins": 100 * self.ins_rate,
                "sent_acc": 100 * self.sentence_acc}


def _accumulate(pairs: Iterable[tuple[Sequence, Sequence]]) -> ErrorStats:
    st = ErrorStats()
    for ref, hyp in pairs:
        st.add(ref, hyp)
    return st


def _require_same_length(refs, hyps) -> None:
    if len(refs) != len(hyps):
        raise ValueError(f"refs/hyps length mismatch: {len(refs)} vs {len(hyps)}")


def word_error_rate(refs: Sequence[str], hyps: Sequence[str],
                    normalize: bool = True) -> ErrorStats:
    _require_same_length(refs, hyps)
    norm = normalize_text if normalize else (lambda s: s)
    return _accumulate((norm(r).split(), norm(h).split()) for r, h in zip(refs, hyps))


def char_error_rate(refs: Sequence[str], hyps: Sequence[str], normalize: bool = True,
                    remove_space: bool = True) -> ErrorStats:
    _require_same_length(refs, hyps)
    norm = normalize_text if normalize else (lambda s: s)

    def chars(s: str) -> list[str]:
        s = norm(s)
        return list(s.replace(" ", "") if remove_space else s)

    return _accumulate((chars(r), chars(h)) for r, h in zip(refs, hyps))


def word_errors(hyp: str, ref: str) -> tuple[int, int]:
    """(word edits, #ref words) — the trainer's inline WER accumulator unit."""
    rw = ref.split()
    return edit_distance(ref.split(), hyp.split()), len(rw)


def char_errors(hyp: str, ref: str) -> tuple[int, int]:
    """(char edits, #ref chars) with spaces stripped — the trainer's inline
    CER accumulator unit."""
    h, r = hyp.replace(" ", ""), ref.replace(" ", "")
    return edit_distance(list(r), list(h)), len(r)
