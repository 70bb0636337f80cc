"""SpecAugment (frequency and time masking), counterpart of
``hnet_mamba_asr_tpu/ops/specaug.py``, in two steps:

1. draw: each utterance's random numbers from its own ``torch.Generator``,
   seeded from the integers (seed, epoch, item_index), so that augmentation
   is a pure function of them and resume is exact (``draw``). The draws do
   not depend on the lengths; ``widths_starts`` turns them into mask widths
   and starts with the JAX arithmetic (the fixed width cap, or the adaptive
   ``time_width_ratio * length`` one).
2. apply: the masks from those widths and starts (``apply_masks``), filled
   with 0.0, the global mean after CMVN.

The generator gives other bits than ``jax.random`` from the same integers;
the tests hand JAX's draws to ``widths_starts`` and ``apply_masks`` and
require JAX's output bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def seed_from(*ints: int) -> int:
    """A 64-bit generator seed from a tuple of integers, through numpy's
    SeedSequence, so that nearby tuples give unrelated streams."""
    state = np.random.SeedSequence(tuple(int(i) for i in ints)).generate_state(2)
    return int(state[0]) << 32 | int(state[1])


def item_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    """The CPU generator of one utterance's draws."""
    return torch.Generator().manual_seed(seed_from(seed, epoch, index))


def draw(seed: int, epoch: int, item_index, *, freq_masks: int = 2, freq_width: int = 27,
         time_masks: int = 2, time_width: int = 100,
         time_width_ratio: float | None = None) -> dict:
    """The batch's raw draws, one generator per row: ``fw`` int64 [B, fm]
    (widths in [0, freq_width]), ``u_fs`` float32 [B, fm], ``tw`` [B, tm]
    (float32 uniforms with ``time_width_ratio``, else int64 widths in
    [0, time_width]) and ``u_ts`` float32 [B, tm]."""
    rows = []
    for index in np.asarray(item_index).reshape(-1).tolist():
        gen = item_generator(seed, epoch, index)
        fw = torch.randint(0, freq_width + 1, (freq_masks,), generator=gen)
        u_fs = torch.rand(freq_masks, generator=gen)
        tw = (torch.rand(time_masks, generator=gen) if time_width_ratio is not None
              else torch.randint(0, time_width + 1, (time_masks,), generator=gen))
        u_ts = torch.rand(time_masks, generator=gen)
        rows.append((fw, u_fs, tw, u_ts))
    return {k: torch.stack([r[i] for r in rows])
            for i, k in enumerate(("fw", "u_fs", "tw", "u_ts"))}


def widths_starts(n_mels: int, lengths: torch.Tensor, fw, u_fs, tw, u_ts, *,
                  time_width_ratio: float | None = None):
    """Raw draws -> (fw, fs, tw, ts) mask widths and starts, int64, as
    ``_augment_one`` computes them in float32: a frequency mask starts in
    [0, F - fw]; a time mask's width is capped at the fixed width or at
    ``int(ratio * length)``, and it never starts inside padding."""
    lengths = lengths.to(torch.int64).reshape(-1, 1)
    fw = fw.to(torch.int64)
    fs = (u_fs * ((n_mels - fw).clamp(min=0) + 1)).to(torch.int64)
    if time_width_ratio is not None:
        cap = (torch.tensor(time_width_ratio, dtype=torch.float32, device=lengths.device)
               * lengths.to(torch.float32)).to(torch.int64)
        tw = (tw * (cap + 1)).to(torch.int64)
    else:
        tw = torch.minimum(tw.to(torch.int64), lengths)
    ts = (u_ts * ((lengths - tw).clamp(min=0) + 1)).to(torch.int64)
    return fw, fs, tw, ts


def _mask_any(size: int, widths: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """[B, n] widths / starts -> [B, size] bool, True where any mask covers."""
    pos = torch.arange(size, device=widths.device)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return hit.any(dim=1)


def apply_masks(feats: torch.Tensor, fw, fs, tw, ts) -> torch.Tensor:
    """feats [B, T, F] with the frequency and time masks set to 0.0."""
    B, T, F = feats.shape
    mask = torch.zeros(B, T, F, dtype=torch.bool, device=feats.device)
    if fw.shape[-1]:
        mask |= _mask_any(F, fw, fs)[:, None, :]
    if tw.shape[-1]:
        mask |= _mask_any(T, tw, ts)[:, :, None]
    return feats.masked_fill(mask, 0.0)


def spec_augment(feats: torch.Tensor, lengths: torch.Tensor, seed: int, epoch: int,
                 item_index, *, freq_masks: int = 2, freq_width: int = 27,
                 time_masks: int = 2, time_width: int = 100,
                 time_width_ratio: float | None = None) -> torch.Tensor:
    """Batched SpecAugment: feats [B, T, F], lengths [B] (feature frames),
    one generator per row from (seed, epoch, item_index[row])."""
    d = draw(seed, epoch, item_index, freq_masks=freq_masks, freq_width=freq_width,
             time_masks=time_masks, time_width=time_width,
             time_width_ratio=time_width_ratio)
    d = {k: v.to(feats.device, non_blocking=True) for k, v in d.items()}
    masks = widths_starts(feats.shape[-1], lengths, d["fw"], d["u_fs"], d["tw"], d["u_ts"],
                          time_width_ratio=time_width_ratio)
    return apply_masks(feats, *masks)


def specaug_kwargs(sc: dict) -> dict:
    """specaug_conf block -> ``spec_augment`` keyword arguments, as the JAX
    ``tasks/asr_task.py::specaug_kwargs`` reads it (only the upper bounds of
    the ranges are used)."""
    out = {"freq_masks": int(sc.get("num_freq_mask", 2)),
           "freq_width": int((sc.get("freq_mask_width_range") or [0, 27])[1]),
           "time_masks": int(sc.get("num_time_mask", 2))}
    ratio = sc.get("time_mask_width_ratio_range")
    if ratio is not None:
        out["time_width_ratio"] = float(ratio[1])
        out["time_width"] = 0
    else:
        out["time_width"] = int((sc.get("time_mask_width_range") or [0, 100])[1])
        out["time_width_ratio"] = None
    return out
