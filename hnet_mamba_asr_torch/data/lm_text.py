"""Text-only dataset for external-LM training, counterpart of
``hnet_mamba_asr_tpu/data/lm_text.py``.

Serves tokenized lines lazily from a large corpus file (a byte-offset index
of its non-blank lines, cached beside the file, so a 40M-line corpus is
never held in memory) or from an in-memory list (the dev sets, from manifest
transcripts). Bucketing uses each line's exact token count, cached per
(corpus, tokenizer), so the sampler's token budget bounds every batch. Both
caches are ``.npz`` sidecars holding the fingerprint of their inputs (file
name, size, mtime; the line count), rebuilt when it changes or the file is
unreadable, written to a per-process tmp and renamed into place.

The JAX package counts tokens in a pool of forked workers; the port counts
them in one process through its tokenizer (``data/tokenizer.py``). Collate
gives a batch with ``row_mask`` (the ASR contract without the waveform
keys), so the same ``Trainer`` trains the LM. ``row_shard`` splits each
global batch's rows between the processes of a multi-rank run.
"""
from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Iterator

import numpy as np

from hnet_mamba_asr_torch.data.dataset import BucketBatchSampler

logger = logging.getLogger(__name__)


def _file_tag(p: Path) -> str:
    s = p.stat()
    return f"{p.name}:{s.st_size}:{s.st_mtime_ns}"


def _sidecar_arrays(cache: Path, fingerprint: str, build) -> dict:
    """Generic npz sidecar cache keyed by a dependency-fingerprint string.

    The fingerprint (file tags of every input the arrays were derived from,
    plus any shape contract) is stored INSIDE the npz; a mismatch — or any
    read error on a truncated/corrupt file — triggers a silent rebuild.
    Writes are per-pid tmp + atomic rename so concurrent writers can't race.
    """
    if cache.exists():
        try:
            with np.load(cache) as z:
                if str(z["fingerprint"]) == fingerprint:
                    return {k: z[k] for k in z.files if k != "fingerprint"}
            logger.info("stale sidecar cache %s (inputs changed); rebuilding",
                        cache.name)
        except Exception:
            logger.warning("unreadable sidecar cache %s; rebuilding", cache.name)
    t0 = time.time()
    arrays = build()
    tmp = cache.with_suffix(f".tmp{os.getpid()}.npz")
    np.savez(tmp, fingerprint=np.str_(fingerprint), **arrays)
    os.replace(tmp, cache)
    logger.info("sidecar cache %s built in %.0f s", cache.name, time.time() - t0)
    return arrays


# ASCII whitespace lookup (the bytes ``bytes.strip()`` removes): a line with
# no byte outside this set is blank and gets no index entry.
_WS_BYTE = np.zeros(256, dtype=bool)
_WS_BYTE[list(b" \t\r\n\v\f")] = True


def _scan_line_offsets(corpus_path: Path) -> np.ndarray:
    """Byte offsets of every non-blank line, via vectorized block scans.

    Streams the file in 8 MiB blocks; newline positions and the "does this
    line contain ink?" test come from numpy reductions, so a 40M-line corpus
    indexes with no per-line Python. Behavioral spec: reference
    src/dcasr/data/lm_text.py:29-39 (offset recorded iff raw.strip()).
    """
    kept: list[np.ndarray] = []
    pos = 0                       # file offset of the current block's start
    line_start = 0                # offset where the (possibly partial) current line began
    line_has_ink = False          # any non-whitespace byte seen in it so far
    with open(corpus_path, "rb") as f:
        while True:
            block = f.read(1 << 23)
            if not block:
                break
            arr = np.frombuffer(block, dtype=np.uint8)
            ink_cum = np.cumsum(~_WS_BYTE[arr])
            ends = np.flatnonzero(arr == ord("\n"))
            if ends.size:
                starts = np.concatenate(
                    ([line_start], pos + ends[:-1].astype(np.int64) + 1))
                ink_to_end = ink_cum[ends]
                ink_in_line = np.diff(ink_to_end, prepend=0)
                if line_has_ink:
                    ink_in_line[0] += 1
                kept.append(starts[ink_in_line > 0])
                line_start = pos + int(ends[-1]) + 1
                line_has_ink = bool(int(ink_cum[-1]) - int(ink_to_end[-1]))
            else:
                line_has_ink = line_has_ink or bool(ink_cum[-1])
            pos += len(block)
    if line_start < pos and line_has_ink:     # unterminated final line
        kept.append(np.asarray([line_start], dtype=np.int64))
    if not kept:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(kept).astype(np.int64)


def load_line_index(corpus_path: str | Path) -> np.ndarray:
    """Cached byte offsets of non-empty lines; rebuilt when the file changes."""
    corpus_path = Path(corpus_path)
    out = _sidecar_arrays(
        corpus_path.with_suffix(corpus_path.suffix + ".idx.npz"),
        f"corpus={_file_tag(corpus_path)}",
        lambda: {"offsets": _scan_line_offsets(corpus_path)})
    return out["offsets"]


def load_token_lengths(corpus_path: str | Path, tokenizer,
                       offsets: np.ndarray) -> np.ndarray:
    """EXACT per-line token counts, cached per (corpus, tokenizer model).

    Exact counts make the sampler's token budget a hard bound (+1 bos/eos wrap
    only) — deterministic device memory, no estimate-overshoot tail. The
    fingerprint ties the cache to both input files AND the line count, so a
    regenerated index can never pair with a stale length table.
    """
    corpus_path = Path(corpus_path)
    tok_path = Path(tokenizer.model_path)
    out = _sidecar_arrays(
        corpus_path.with_suffix(corpus_path.suffix + f".len.{tok_path.stem}.npz"),
        f"corpus={_file_tag(corpus_path)};tok={_file_tag(tok_path)};"
        f"n={len(offsets)}",
        lambda: {"lengths": _count_tokens(corpus_path, tok_path, offsets)})
    return out["lengths"]


def _count_tokens(corpus_path: Path, tok_path: Path, offsets: np.ndarray) -> np.ndarray:
    """Each indexed line's token count, in one process."""
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    tok = Tokenizer(tok_path)
    out = np.empty(len(offsets), dtype=np.int32)
    with open(corpus_path, "rb") as fh:
        for i, off in enumerate(offsets):
            fh.seek(int(off))
            out[i] = len(tok.encode(fh.readline().decode("utf-8").strip()))
    return out


class LMTextDataset:
    """Tokenized text lines for next-token LM training (lazy or in-memory)."""

    def __init__(self, tokenizer, *, corpus_path: str | Path | None = None,
                 lines: list[str] | None = None, max_tokens: int = 512):
        if (corpus_path is None) == (lines is None):
            raise ValueError("exactly one of corpus_path / lines")
        self.tokenizer = tokenizer
        self.pad_id = tokenizer.pad_id
        self.max_tokens = int(max_tokens)
        self._fh = None
        self.corpus_path = Path(corpus_path) if corpus_path is not None else None
        if self.corpus_path is not None:
            self.offsets = load_line_index(self.corpus_path)
            counts = load_token_lengths(self.corpus_path, tokenizer, self.offsets)
            self.lengths = [max(1, min(self.max_tokens, int(c))) for c in counts]
            self.lines = None
        else:
            self.lines = [l.strip() for l in lines if l.encode("utf-8").strip()]
            self.offsets = None
            self.lengths = [max(1, min(self.max_tokens, len(tokenizer.encode(l))))
                            for l in self.lines]
        self.epoch = 0
        logger.info("LMTextDataset: %d lines (%s, max_tokens=%d)", len(self.lengths),
                    self.corpus_path.name if self.corpus_path else "in-memory",
                    self.max_tokens)

    @classmethod
    def from_manifest(cls, manifest_path: str | Path, tokenizer, **kw) -> "LMTextDataset":
        with open(manifest_path, encoding="utf-8") as f:
            lines = [json.loads(l)["text"] for l in f if l.strip()]
        return cls(tokenizer, lines=lines, **kw)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _line(self, idx: int) -> str:
        if self.lines is not None:
            return self.lines[idx]
        if self._fh is None:
            self._fh = open(self.corpus_path, "rb")
        self._fh.seek(int(self.offsets[idx]))
        return self._fh.readline().decode("utf-8").strip()

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, idx: int) -> dict:
        ids = self.tokenizer.encode(self._line(idx))[:self.max_tokens]
        if not ids:                                  # unknown-only line: keep one token
            ids = [self.tokenizer.unk_id]
        return {"tokens": np.asarray(ids, dtype=np.int32), "id": f"line{idx}"}


def _fill_lm_rows(rows: list[dict | None], u_pad: int, pad_id: int) -> dict:
    """Materialize padded LM arrays for ``rows`` (None = padding row)."""
    R = len(rows)
    tokens = np.full((R, u_pad), pad_id, dtype=np.int32)
    lens = np.zeros(R, dtype=np.int32)
    row_mask = np.zeros(R, dtype=bool)
    ids = []
    for i, it in enumerate(rows):
        if it is None:
            continue
        tokens[i, :len(it["tokens"])] = it["tokens"]
        lens[i] = len(it["tokens"])
        row_mask[i] = True
        ids.append(it["id"])
    return {"tokens": tokens, "token_lens": lens, "row_mask": row_mask,
            "ids": ids}


def collate_lm(items: list[dict], *, pad_id: int, batch_multiple: int = 1,
               token_multiple: int = 16) -> dict:
    """Static-shape LM batch with row masking (tokens-only contract)."""
    B = len(items)
    B_pad = -(-B // batch_multiple) * batch_multiple
    u_max = max(len(it["tokens"]) for it in items)
    u_pad = max(-(-u_max // token_multiple) * token_multiple, token_multiple)
    rows = list(items) + [None] * (B_pad - B)
    return _fill_lm_rows(rows, u_pad, pad_id)


class LMDataLoader:
    """Sampler -> items -> ``collate_lm``. ``row_shard=(rank, count)`` is the
    multi-process mode (see ``data/dataset.py::DataLoader``): the sampler is
    unsharded, every rank takes the pad targets from the dataset's cached
    token lengths and materializes only its contiguous row slice."""

    def __init__(self, dataset: LMTextDataset, sampler: BucketBatchSampler,
                 batch_multiple: int = 1, row_shard: tuple[int, int] | None = None,
                 token_multiple: int = 16):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_multiple = batch_multiple
        self.token_multiple = token_multiple
        self.row_shard = tuple(row_shard) if row_shard else None
        if self.row_shard:
            rank, count = self.row_shard
            if not 0 <= rank < count:
                raise ValueError(f"row_shard rank {rank} not in [0, {count})")
            if batch_multiple % count:
                raise ValueError(
                    f"row_shard needs batch_multiple ({batch_multiple}) "
                    f"divisible by process count ({count})")

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[dict]:
        for idxs in self.sampler:
            if self.row_shard is None:
                yield collate_lm([self.dataset[i] for i in idxs], pad_id=self.dataset.pad_id,
                                 batch_multiple=self.batch_multiple,
                                 token_multiple=self.token_multiple)
                continue
            rank, count = self.row_shard
            B = len(idxs)
            B_pad = -(-B // self.batch_multiple) * self.batch_multiple
            u_max = max(self.dataset.lengths[i] for i in idxs)
            u_pad = max(-(-u_max // self.token_multiple) * self.token_multiple,
                        self.token_multiple)
            per = B_pad // count
            rows = []
            for r in range(rank * per, (rank + 1) * per):
                if r >= B:
                    rows.append(None)
                    continue
                it = self.dataset[idxs[r]]
                if len(it["tokens"]) != self.dataset.lengths[idxs[r]]:
                    raise ValueError(
                        f"line {idxs[r]}: cached token length "
                        f"{self.dataset.lengths[idxs[r]]} != actual "
                        f"{len(it['tokens'])}; a stale token-length cache "
                        f"would break the multi-process equal-shape contract")
                rows.append(it)
            yield _fill_lm_rows(rows, u_pad, self.dataset.pad_id)


def make_lm_dataloader(dataset: LMTextDataset, batch_tokens: int, *, shuffle: bool,
                       seed: int = 0, num_replicas: int = 1, rank: int = 0,
                       batch_multiple: int = 1, row_shard: bool = False):
    """-> (LMDataLoader, BucketBatchSampler). ``row_shard=True`` makes (rank,
    num_replicas) row slices of one shared global batch sequence; otherwise
    ranks take disjoint batches."""
    sampler = BucketBatchSampler(dataset.lengths, batch_tokens,
                                 1 if row_shard else num_replicas, 0 if row_shard else rank,
                                 shuffle=shuffle, seed=seed)
    return LMDataLoader(dataset, sampler, batch_multiple,
                        row_shard=(rank, num_replicas) if row_shard else None), sampler
