"""Subword BPE tokenizer with the fixed special ids unk 0 / bos 1 / eos 2 /
pad 3, counterpart of ``hnet_mamba_asr_tpu/data/tokenizer.py`` (the port
keeps its own copy of the pure-Python path; the JAX package's C++ training
and segmentation loops are not ported, and produce the same merges and ids).

- learned pieces occupy [4, V); the CTC blank is appended at id V
  (``blank_id = vocab_size``), so ``encode`` / ``decode`` stay in [0, V);
- pieces use the ``▁`` word-boundary convention; ``decode`` joins pieces
  and maps ``▁`` back to a space.

Training is classic BPE over whitespace-split words (merges never cross a
word boundary): count word frequencies, seed with the character alphabet
(each word prefixed by ``▁``), then greedily merge the most frequent adjacent
pair until the vocab budget is reached; ties break lexicographically. The
model is a JSON ``.model`` file (+ a readable ``.vocab``), the same format
as the JAX package's, so either package loads the other's file.
"""
from __future__ import annotations

import json
import logging
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Sequence

logger = logging.getLogger(__name__)

DEFAULT_VOCAB_SIZE = 500
WORD_BOUNDARY = "▁"  # ▁
UNK_ID, BOS_ID, EOS_ID, PAD_ID = 0, 1, 2, 3
SPECIAL_PIECES = ("<unk>", "<s>", "</s>", "<pad>")
MODEL_VERSION = 1


def _words(text: str) -> list[str]:
    return text.split()


def _word_symbols(word: str) -> tuple[str, ...]:
    """'the' -> ('▁', 't', 'h', 'e'); the boundary marker is its own symbol."""
    return (WORD_BOUNDARY,) + tuple(word)


def train_bpe(word_freqs: Counter, n_merges_budget: int) -> tuple[list[str], list[tuple[str, str]]]:
    """Greedy BPE: returns (alphabet in frequency order, merges in rank order).

    Pair counting is incremental per merge (only words containing the merged
    pair are re-segmented), which keeps training tractable in pure Python.
    """
    # words as mutable symbol tuples
    segs: dict[tuple[str, ...], int] = {}
    char_freq: Counter = Counter()
    for w, f in word_freqs.items():
        syms = _word_symbols(w)
        segs[syms] = segs.get(syms, 0) + f
        for s in syms:
            char_freq[s] += f
    alphabet = [c for c, _ in sorted(char_freq.items(), key=lambda kv: (-kv[1], kv[0]))]

    pair_freq: Counter = Counter()
    pair_words: dict[tuple[str, str], set] = {}
    seg_list = list(segs.items())          # [(symbols, freq)]

    def count_pairs(widx: int):
        syms, f = seg_list[widx]
        for a, b in zip(syms, syms[1:]):
            pair_freq[(a, b)] += f
            pair_words.setdefault((a, b), set()).add(widx)

    for widx in range(len(seg_list)):
        count_pairs(widx)

    merges: list[tuple[str, str]] = []
    while len(merges) < n_merges_budget and pair_freq:
        # most frequent pair; deterministic lexicographic tie-break
        best = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0][0], kv[0][1]))[0]
        if pair_freq[best] < 2:
            break                                       # singleton merges add no value
        merges.append(best)
        merged = best[0] + best[1]
        for widx in list(pair_words.get(best, ())):
            syms, f = seg_list[widx]
            # remove old pair counts for this word
            for a, b in zip(syms, syms[1:]):
                pair_freq[(a, b)] -= f
                if pair_freq[(a, b)] <= 0:
                    del pair_freq[(a, b)]
                ws = pair_words.get((a, b))
                if ws is not None:
                    ws.discard(widx)
            # apply the merge within the word
            out: list[str] = []
            i = 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == best[0] and syms[i + 1] == best[1]:
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            seg_list[widx] = (tuple(out), f)
            # add new pair counts
            syms2 = seg_list[widx][0]
            for a, b in zip(syms2, syms2[1:]):
                pair_freq[(a, b)] += f
                pair_words.setdefault((a, b), set()).add(widx)
    return alphabet, merges


class Tokenizer:
    """BPE tokenizer with the fixed special-token layout (JSON model file)."""

    def __init__(self, model_path: str | Path):
        self.model_path = str(model_path)
        with open(model_path, encoding="utf-8") as f:
            model = json.load(f)
        if model.get("format") != "hmasr-bpe":
            raise ValueError(f"{model_path}: not an hmasr-bpe model file")
        self.pieces: list[str] = model["pieces"]        # id-ordered, specials first
        if tuple(self.pieces[:4]) != SPECIAL_PIECES:
            raise ValueError(
                f"{model_path}: special pieces {self.pieces[:4]} violate the fixed "
                f"contract {SPECIAL_PIECES} (unk=0,bos=1,eos=2,pad=3); retrain via "
                "Tokenizer.train()")
        self.merges: list[tuple[str, str]] = [tuple(m) for m in model["merges"]]
        self.vocab_size = len(self.pieces)
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = UNK_ID, BOS_ID, EOS_ID, PAD_ID
        self.blank_id = self.vocab_size                 # CTC blank, beyond the vocab
        self._piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self._merge_rank = {m: r for r, m in enumerate(self.merges)}
        self._word_ids = lru_cache(maxsize=1 << 18)(self._word_ids_uncached)
        logger.debug("Tokenizer(%s) vocab=%d blank=%d", self.model_path,
                     self.vocab_size, self.blank_id)

    # ---- training ------------------------------------------------------------
    @classmethod
    def train(cls, corpus: str | Path | Iterable[str], model_prefix: str | Path,
              vocab_size: int = DEFAULT_VOCAB_SIZE, character_coverage: float = 1.0,
              hard_vocab_limit: bool = True, **_ignored) -> "Tokenizer":
        """Learn a BPE model; writes <model_prefix>.model (JSON) and .vocab.

        ``vocab_size`` counts specials + alphabet + merged pieces. With
        ``character_coverage < 1.0`` the rarest characters are dropped from the
        alphabet (they encode as unk). ``hard_vocab_limit=False`` permits a
        smaller final vocab when the corpus can't support ``vocab_size``.
        """
        model_prefix = str(model_prefix)
        Path(model_prefix).parent.mkdir(parents=True, exist_ok=True)
        if isinstance(corpus, (str, Path)):
            with open(corpus, encoding="utf-8") as f:
                lines = [ln.rstrip("\n") for ln in f]
        else:
            lines = [str(ln).rstrip("\n") for ln in corpus]
        word_freqs: Counter = Counter()
        for ln in lines:
            word_freqs.update(_words(ln))
        if not word_freqs:
            raise ValueError("empty training corpus")

        n_special = len(SPECIAL_PIECES)
        alphabet_full, _ = train_bpe(word_freqs, 0)
        if character_coverage < 1.0:
            # keep the most frequent chars covering the requested mass (▁ always kept)
            char_freq: Counter = Counter()
            for w, f in word_freqs.items():
                for s in _word_symbols(w):
                    char_freq[s] += f
            total = sum(char_freq.values())
            kept, mass = [], 0
            for c, f in sorted(char_freq.items(), key=lambda kv: (-kv[1], kv[0])):
                kept.append(c)
                mass += f
                if mass / total >= character_coverage and c != WORD_BOUNDARY:
                    break
            if WORD_BOUNDARY not in kept:
                kept.append(WORD_BOUNDARY)
            alphabet_full = kept
        budget = vocab_size - n_special - len(alphabet_full)
        if budget < 0:
            if hard_vocab_limit:
                raise ValueError(
                    f"vocab_size={vocab_size} smaller than specials+alphabet "
                    f"({n_special}+{len(alphabet_full)})")
            alphabet_full = alphabet_full[:max(0, vocab_size - n_special)]
            budget = 0
        _, merges = train_bpe(word_freqs, budget)
        pieces = list(SPECIAL_PIECES) + alphabet_full + [a + b for a, b in merges]
        # merged strings can collide with alphabet entries only if a merge result
        # equals a single char — impossible (len >= 2) — but two merges can
        # produce the same string via different paths; dedupe keeping first.
        seen, uniq = set(), []
        for p in pieces:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        pieces = uniq[:vocab_size]
        if hard_vocab_limit and len(pieces) < vocab_size:
            raise ValueError(
                f"corpus supports only {len(pieces)} pieces < vocab_size={vocab_size}; "
                "pass hard_vocab_limit=False to accept a smaller vocab")
        model = {"format": "hmasr-bpe", "version": MODEL_VERSION,
                 "pieces": pieces, "merges": [list(m) for m in merges]}
        model_file = f"{model_prefix}.model"
        with open(model_file, "w", encoding="utf-8") as f:
            json.dump(model, f, ensure_ascii=False)
        with open(f"{model_prefix}.vocab", "w", encoding="utf-8") as f:
            for i, p in enumerate(pieces):
                f.write(f"{p}\t{i}\n")
        logger.info("trained BPE tokenizer: vocab=%d -> %s", len(pieces), model_file)
        return cls(model_file)

    # ---- encode / decode -------------------------------------------------------
    def _segment_word(self, word: str) -> tuple[str, ...]:
        """Greedy merge: repeatedly merge the adjacent pair of lowest rank."""
        syms = list(_word_symbols(word))
        rank = self._merge_rank
        while len(syms) > 1:
            best_rank, best_i = None, -1
            for i in range(len(syms) - 1):
                r = rank.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        return tuple(syms)

    def _word_ids_uncached(self, word: str) -> tuple[int, ...]:
        lookup = self._piece_to_id
        return tuple(lookup.get(piece, self.unk_id)
                     for piece in self._segment_word(word))

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> list[int]:
        """text -> piece ids in [0, vocab_size); optional bos/eos wrapping."""
        ids: list[int] = []
        for w in _words(text):
            ids.extend(self._word_ids(w))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """piece ids -> text; drops blank/bos/eos/pad and out-of-range ids."""
        drop = {self.bos_id, self.eos_id, self.pad_id}
        out = []
        for i in ids:
            i = int(i)
            if 0 <= i < self.vocab_size and i not in drop:
                out.append(self.pieces[i])
        return "".join(out).replace(WORD_BOUNDARY, " ").strip()

    def __len__(self) -> int:
        return self.vocab_size
