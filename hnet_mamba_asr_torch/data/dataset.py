"""The host batch contract, counterpart of the collate and sampler part of
``hnet_mamba_asr_tpu/data/dataset.py`` (numpy only; the port keeps its own
copy rather than import the JAX package).

An item is ``{"wave" float32 [n], "n_samples", "tokens" int32 [U], "id",
"index"}``. ``collate_batch`` pads items into a batch dict ``{wave,
wave_lens, tokens, token_lens, row_mask, aug_ref = [seed, epoch],
item_index, ids}``: waves to a length snapped to a geometric grid of
feature frames, tokens to a multiple of 8, rows to a multiple of
``batch_multiple`` (padding rows have ``row_mask`` False). With
``wire_dtype="int16"`` the waves travel as PCM16 and the frontend
(``ops/melspec.py``) rescales them by 1/32768 on the device.
``BucketBatchSampler`` makes length-bucketed batches under a ``max_frames``
budget, shuffled by (seed + epoch). ``manifest_items`` reads a manifest of
WAV and FLAC files into items (the JAX ``ASRDataset`` without
augmentation); speed perturbation is not ported.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

WIN_LENGTH = 400
HOP_LENGTH = 160


def feat_frames(n_samples: int) -> int:
    """Feature-frame count for an n-sample waveform (frontend contract)."""
    return max(0, 1 + (n_samples - WIN_LENGTH) // HOP_LENGTH)


def length_grid(value: int, *, base: int = 256, ratio: float = 1.25) -> int:
    """Snap a length up to a geometric grid (a bounded set of shapes)."""
    if value <= base:
        return base
    steps = math.ceil(math.log(value / base) / math.log(ratio))
    return int(math.ceil(base * ratio ** steps))


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
    from hnet_mamba_asr_torch.data.audio import load_manifest, read_audio
    items = []
    for i, e in enumerate(load_manifest(manifest)):
        wave, sr = read_audio(e["audio"])
        if sr != sample_rate:
            raise ValueError(f"{e['audio']}: sample rate {sr} != {sample_rate}")
        items.append({"wave": wave.astype(np.float32), "n_samples": len(wave),
                      "tokens": np.asarray(tokenizer.encode(e["text"]), dtype=np.int32),
                      "id": e["id"], "index": i})
    return items
