"""The host data pipeline, counterpart of ``hnet_mamba_asr_tpu/data/dataset.py``
(numpy only; the port keeps its own copy rather than import the JAX package).

The host reads audio (WAV, or FLAC through the host library), speed-perturbs
it, tokenizes and pads; waveforms go to the device raw and the frontend
(log-mel, CMVN, SpecAugment) runs in the model's step. SpecAugment is a
function of (seed, epoch, item index), shipped in the batch.

- ``ASRDataset``: manifest entries x speed factors (each utterance once per
  factor, ids ``<id>#sp<f>``); ``perturbed_samples`` gives each item's exact
  sample count from the manifest alone; with ``perturb_cache_dir`` each
  (utterance, factor) is resampled once into a float32 ``.npy`` (tmp, then
  ``os.replace``) and read back bitwise, a file of the wrong length or dtype
  (a crashed write, a stale manifest) recomputed and replaced.
- ``collate_batch`` pads items into a batch dict ``{wave, wave_lens, tokens,
  token_lens, row_mask, aug_ref = [seed, epoch], item_index, ids}``: waves to
  a length snapped to a geometric grid of feature frames, tokens to a
  multiple of 8, rows to a multiple of ``batch_multiple`` (padding rows have
  ``row_mask`` False). With ``wire_dtype="int16"`` the waves travel as PCM16
  and the frontend (``ops/melspec.py``) rescales them by 1/32768 on the
  device.
- ``BucketBatchSampler`` makes length-bucketed batches under a
  ``max_frames`` budget, shuffled by (seed + epoch).
- ``DataLoader`` fetches and collates the sampler's batches, in a
  background thread with a bounded queue when ``prefetch`` > 0 (order kept,
  a worker's exception raised in the consumer). ``row_shard=(rank, count)``
  is the multi-process mode: every rank iterates the same unsharded batch
  sequence and materializes only its contiguous row slice, padded to the
  targets of all the batch's rows (from metadata), so every rank holds one
  shape and the slices together are the one global batch.
- ``ItemLoader`` / ``manifest_items`` batch items held in memory.
"""
from __future__ import annotations

import logging
import math
import os
import queue
import threading
from fractions import Fraction
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from hnet_mamba_asr_torch.data.audio import apply_speed_perturb, load_manifest, read_audio
from hnet_mamba_asr_torch.data.manifests import HOP_LENGTH, SAMPLE_RATE, WIN_LENGTH, feat_frames

logger = logging.getLogger(__name__)


def length_grid(value: int, *, base: int = 256, ratio: float = 1.25) -> int:
    """Snap a length up to a geometric grid (a bounded set of shapes)."""
    if value <= base:
        return base
    steps = math.ceil(math.log(value / base) / math.log(ratio))
    return int(math.ceil(base * ratio ** steps))


def perturbed_samples(n_samples: int, sample_rate: int, factor: float) -> int:
    """The exact sample count ``apply_speed_perturb`` returns, from metadata:
    ``resample``'s arithmetic term for term (the same Fraction, the same
    float ceil)."""
    if factor == 1.0:
        return int(n_samples)
    virtual_sr = int(round(sample_rate / float(factor)))
    if virtual_sr == sample_rate:
        return int(n_samples)
    frac = Fraction(virtual_sr, sample_rate).limit_denominator(1000)
    return int(np.ceil(n_samples * frac.numerator / frac.denominator))


class ASRDataset:
    """Items ``{wave, n_samples, tokens, id, index}``; lengths known up front.
    ``cache_hits`` / ``cache_misses`` count the perturb cache's reads and
    writes."""

    def __init__(self, manifest, tokenizer, *, augment: bool = False, seed: int = 0,
                 speed_perturb: Sequence[float] | None = None,
                 sample_rate: int = SAMPLE_RATE,
                 perturb_cache_dir: str | Path | None = None):
        self.entries = (load_manifest(manifest)
                        if isinstance(manifest, (str, Path)) else list(manifest))
        self.tokenizer = tokenizer
        self.augment = augment
        self.seed = seed
        self.sample_rate = sample_rate
        self.epoch = 0
        self.factors = ([float(f) for f in speed_perturb]
                        if (augment and speed_perturb) else [1.0])
        self.items = [(i, f) for i in range(len(self.entries)) for f in self.factors]
        self.samples = [perturbed_samples(self.entries[i]["frames"], sample_rate, f)
                        for i, f in self.items]
        self.lengths = [feat_frames(s) for s in self.samples]
        self.pad_id = tokenizer.pad_id
        self.perturb_cache_dir = Path(perturb_cache_dir) if perturb_cache_dir else None
        if self.perturb_cache_dir is not None:
            self.perturb_cache_dir.mkdir(parents=True, exist_ok=True)
        self.cache_hits = self.cache_misses = 0
        self._tok_len_cache: dict[int, int] = {}

    def token_len(self, item: int) -> int:
        """Token count for item ``item`` from text alone (cached per entry)."""
        idx, _ = self.items[item]
        n = self._tok_len_cache.get(idx)
        if n is None:
            n = len(self.tokenizer.encode(self.entries[idx]["text"]))
            self._tok_len_cache[idx] = n
        return n

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _read(self, e: dict) -> np.ndarray:
        wave, sr = read_audio(e["audio"])
        if sr != self.sample_rate:
            raise ValueError(f"{e['audio']}: sample rate {sr} != {self.sample_rate}")
        return wave

    def _cached_perturb(self, e: dict, factor: float) -> np.ndarray:
        """The perturbed wave from the cache, or computed and cached."""
        cache = self.perturb_cache_dir / f"{e['id']}#sp{factor}.npy"
        expect = perturbed_samples(e["frames"], self.sample_rate, factor)
        if cache.exists():
            try:
                w = np.load(cache)
                if len(w) == expect and w.dtype == np.float32:
                    self.cache_hits += 1
                    return w
            except (OSError, ValueError, EOFError):     # a torn or corrupt file is recomputed
                pass
        self.cache_misses += 1
        wave = apply_speed_perturb(self._read(e), self.sample_rate, factor).astype(np.float32)
        tmp = cache.with_suffix(f".tmp{os.getpid()}.npy")
        try:
            np.save(tmp, wave)
            os.replace(tmp, cache)
        except OSError as err:                 # a read-only or full disk: train on
            tmp.unlink(missing_ok=True)
            logger.warning("perturb cache %s not written: %s", cache, err)
        return wave

    def __getitem__(self, i: int) -> dict:
        idx, factor = self.items[i]
        e = self.entries[idx]
        if factor != 1.0 and self.perturb_cache_dir is not None:
            wave = self._cached_perturb(e, factor)
        else:
            wave = self._read(e)
            if factor != 1.0:
                wave = apply_speed_perturb(wave, self.sample_rate, factor)
        uid = e["id"] if factor == 1.0 else f"{e['id']}#sp{factor}"
        tokens = np.asarray(self.tokenizer.encode(e["text"]), dtype=np.int32)
        return {"wave": wave.astype(np.float32), "n_samples": len(wave),
                "tokens": tokens, "id": uid, "index": i}


def pad_targets(n_samples_list: Sequence[int], token_lens_list: Sequence[int], *,
                batch_multiple: int = 1, snap_lengths: bool = True,
                token_multiple: int = 8) -> tuple[int, int, int]:
    """(B_pad, n_pad, u_pad) for a batch, from length metadata only."""
    B = len(n_samples_list)
    B_pad = -(-B // batch_multiple) * batch_multiple
    n_max = max(n_samples_list)
    if snap_lengths:
        t_pad = length_grid(feat_frames(n_max))
        n_pad = (t_pad - 1) * HOP_LENGTH + WIN_LENGTH
    else:
        n_pad = n_max
    u_max = max(token_lens_list)
    u_pad = max(-(-u_max // token_multiple) * token_multiple, token_multiple)
    return B_pad, n_pad, u_pad


def _fill_rows(rows: Sequence[dict | None], n_pad: int, u_pad: int, *,
               pad_id: int, seed: int, epoch: int,
               wire_dtype: str = "float32") -> dict:
    """Padded arrays for ``rows`` (None = a padding row)."""
    R = len(rows)
    wave = np.zeros((R, n_pad), dtype=np.int16 if wire_dtype == "int16" else np.float32)
    # a padding row's wave_lens covers one window, so the frontend is valid
    wave_lens = np.full(R, WIN_LENGTH, dtype=np.int32)
    tokens = np.full((R, u_pad), pad_id, dtype=np.int32)
    token_lens = np.zeros(R, dtype=np.int32)
    indices = np.zeros(R, dtype=np.int32)
    row_mask = np.zeros(R, dtype=bool)
    ids = []
    for i, s in enumerate(rows):
        if s is None:
            continue
        w = s["wave"][:n_pad]
        if wave.dtype == np.int16:
            w = np.clip(np.round(w * 32768.0), -32768, 32767)
        wave[i, :min(s["n_samples"], n_pad)] = w
        wave_lens[i] = min(s["n_samples"], n_pad)
        tokens[i, :len(s["tokens"])] = s["tokens"]
        token_lens[i] = len(s["tokens"])
        indices[i] = s["index"]
        row_mask[i] = True
        ids.append(s["id"])
    return {"wave": wave, "wave_lens": wave_lens, "tokens": tokens,
            "token_lens": token_lens, "row_mask": row_mask,
            "aug_ref": np.array([seed, epoch], dtype=np.int32),
            "item_index": indices, "ids": ids}


def collate_batch(samples: Sequence[dict], *, pad_id: int, seed: int, epoch: int,
                  batch_multiple: int = 1, snap_lengths: bool = True,
                  token_multiple: int = 8, wire_dtype: str = "float32") -> dict:
    """Pad a list of items into a batch with row masking."""
    B_pad, n_pad, u_pad = pad_targets(
        [s["n_samples"] for s in samples], [len(s["tokens"]) for s in samples],
        batch_multiple=batch_multiple, snap_lengths=snap_lengths,
        token_multiple=token_multiple)
    rows = list(samples) + [None] * (B_pad - len(samples))
    return _fill_rows(rows, n_pad, u_pad, pad_id=pad_id, seed=seed, epoch=epoch,
                      wire_dtype=wire_dtype)


class BucketBatchSampler:
    """Length-bucketed batches under a ``max_frames = max(B * T)`` budget,
    sharded across ``num_replicas`` with an equal batch count each, shuffled
    deterministically by (seed + epoch)."""

    def __init__(self, lengths, max_frames: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.lengths = list(lengths)
        self.max_frames = max_frames
        self.num_replicas = max(1, num_replicas)
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._batches = self._compute()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._batches = self._compute()

    def _all_batches(self) -> list[list[int]]:
        order = sorted(range(len(self.lengths)), key=lambda i: self.lengths[i])
        batches, cur, cur_max = [], [], 0
        for i in order:
            new_max = max(cur_max, self.lengths[i])
            if cur and (len(cur) + 1) * new_max > self.max_frames:
                batches.append(cur)
                cur, cur_max = [i], self.lengths[i]
            else:
                cur.append(i)
                cur_max = new_max
        if cur:
            batches.append(cur)
        return batches

    def _compute(self) -> list[list[int]]:
        batches = self._all_batches()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            batches = [batches[k] for k in rng.permutation(len(batches))]
        usable = (len(batches) // self.num_replicas) * self.num_replicas
        return batches[self.rank:usable:self.num_replicas]

    def __iter__(self):
        return iter(self._batches)

    def __len__(self) -> int:
        return len(self._batches)


class DataLoader:
    """Sampler -> fetch -> collate, deterministic; ``set_epoch`` reshuffles
    and stamps the epoch for augmentation. ``prefetch`` > 0 builds batches in
    a background thread ahead of the consumer through a queue of that size
    (order kept; a worker exception is raised in the consumer).

    ``row_shard=(rank, count)``: the sampler is unsharded (every rank
    iterates the same global batches) and this rank materializes rows
    ``[rank * B_pad / count, (rank + 1) * B_pad / count)``; the pad targets
    come from every row's metadata, so all ranks hold one padded shape. An
    audio file whose length disagrees with its manifest raises: the shape
    contract rests on the metadata."""

    def __init__(self, dataset: ASRDataset, sampler: BucketBatchSampler, *,
                 batch_multiple: int = 1, snap_lengths: bool = True,
                 prefetch: int = 0, row_shard: tuple[int, int] | None = None,
                 wire_dtype: str = "float32"):
        self.row_shard = tuple(row_shard) if row_shard else None
        if self.row_shard:
            rank, count = self.row_shard
            if not 0 <= rank < count:
                raise ValueError(f"row_shard rank {rank} not in [0, {count})")
            if batch_multiple % count:
                raise ValueError(
                    f"row_shard needs batch_multiple ({batch_multiple}) "
                    f"divisible by process count ({count}) so every process "
                    f"gets an equal row slice")
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32|int16, got {wire_dtype!r}")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_multiple = batch_multiple
        self.snap_lengths = snap_lengths
        self.prefetch = int(prefetch)
        self.wire_dtype = wire_dtype

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _fetch_checked(self, item: int, expect_samples: int) -> dict:
        s = self.dataset[item]
        if s["n_samples"] != expect_samples:
            e = self.dataset.entries[self.dataset.items[item][0]]
            raise ValueError(
                f"{e['audio']}: audio has {s['n_samples']} samples but the "
                f"manifest-derived expectation is {expect_samples}. On a "
                f"row-sharded (multi-process) run pad targets come from "
                f"metadata, so a lying manifest would silently break the "
                f"equal-shape contract; fix the manifest 'frames' field.")
        return s

    def _make(self, batch_idx) -> dict:
        ds = self.dataset
        if self.row_shard is None:
            return collate_batch([ds[i] for i in batch_idx], pad_id=ds.pad_id,
                                 seed=ds.seed, epoch=ds.epoch,
                                 batch_multiple=self.batch_multiple,
                                 snap_lengths=self.snap_lengths, wire_dtype=self.wire_dtype)
        rank, count = self.row_shard
        n_samps = [ds.samples[i] for i in batch_idx]
        B_pad, n_pad, u_pad = pad_targets(
            n_samps, [ds.token_len(i) for i in batch_idx],
            batch_multiple=self.batch_multiple, snap_lengths=self.snap_lengths)
        per = B_pad // count
        rows = [self._fetch_checked(batch_idx[r], n_samps[r]) if r < len(batch_idx) else None
                for r in range(rank * per, (rank + 1) * per)]
        return _fill_rows(rows, n_pad, u_pad, pad_id=ds.pad_id, seed=ds.seed, epoch=ds.epoch,
                          wire_dtype=self.wire_dtype)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            for batch_idx in self.sampler:
                yield self._make(batch_idx)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker(indices):
            try:
                for batch_idx in indices:
                    q.put(("ok", self._make(batch_idx)))
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                q.put(("err", e))
            finally:
                q.put(("ok", done))

        threading.Thread(target=worker, args=(list(self.sampler),), daemon=True).start()
        while True:
            kind, item = q.get()
            if kind == "err":
                raise item
            if item is done:
                break
            yield item


def make_dataloader(dataset: ASRDataset, max_frames: int, *, shuffle: bool = False,
                    seed: int = 0, num_replicas: int = 1, rank: int = 0,
                    batch_multiple: int = 1, snap_lengths: bool = True,
                    prefetch: int = 0, row_shard: bool = False,
                    wire_dtype: str = "float32"):
    """-> (DataLoader, BucketBatchSampler). ``row_shard=True`` turns (rank,
    num_replicas) into row slices of one shared global batch sequence (the
    multi-process contract, see DataLoader); otherwise ranks take disjoint
    batches."""
    sampler = BucketBatchSampler(dataset.lengths, max_frames,
                                 1 if row_shard else num_replicas, 0 if row_shard else rank,
                                 shuffle=shuffle, seed=seed)
    loader = DataLoader(dataset, sampler, batch_multiple=batch_multiple,
                        snap_lengths=snap_lengths, prefetch=prefetch,
                        row_shard=(rank, num_replicas) if row_shard else None,
                        wire_dtype=wire_dtype)
    return loader, sampler


class ItemLoader:
    """Items (in memory) -> batches: ``BucketBatchSampler`` over their
    feature lengths, then ``collate_batch``. ``set_epoch`` reshuffles and
    stamps the epoch into ``aug_ref``."""

    def __init__(self, items: Sequence[dict], max_frames: int, *, pad_id: int = 3,
                 seed: int = 0, shuffle: bool = True, **collate_kw):
        self.items = list(items)
        self.sampler = BucketBatchSampler([feat_frames(s["n_samples"]) for s in self.items],
                                          max_frames, shuffle=shuffle, seed=seed)
        self.pad_id, self.seed, self.collate_kw = pad_id, seed, collate_kw

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __iter__(self):
        for idx in self.sampler:
            yield collate_batch([self.items[i] for i in idx], pad_id=self.pad_id,
                                seed=self.seed, epoch=self.sampler.epoch, **self.collate_kw)

    def __len__(self) -> int:
        return len(self.sampler)


def manifest_items(manifest, tokenizer, *, sample_rate: int = 16000) -> list[dict]:
    """A manifest -> items: each entry's audio (WAV or FLAC, ``read_audio``)
    as float32 and its text encoded by ``tokenizer`` (``data/tokenizer.py``),
    ids and indices in manifest order."""
    items = []
    for i, e in enumerate(load_manifest(manifest)):
        wave, sr = read_audio(e["audio"])
        if sr != sample_rate:
            raise ValueError(f"{e['audio']}: sample rate {sr} != {sample_rate}")
        items.append({"wave": wave.astype(np.float32), "n_samples": len(wave),
                      "tokens": np.asarray(tokenizer.encode(e["text"]), dtype=np.int32),
                      "id": e["id"], "index": i})
    return items
