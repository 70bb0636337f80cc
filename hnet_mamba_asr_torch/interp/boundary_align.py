"""Boundary-alignment scoring: learned H-Net boundaries vs forced-aligned truth.
Counterpart of ``hnet_mamba_asr_tpu/interp/boundary_align.py``: the scoring
is a copy; ``collect_boundaries`` reads the port's ``EncoderOutput``, whose
tensors may sit on the card and be bf16 (``host_array`` moves them).

Metrics: precision/recall/F1 within a ±tolerance, over-segmentation, the
R-value of Räsänen et al. (2009), and a matched-count random floor (capability
spec: reference src/dcasr/interp/boundary_align.py).

Timing model, derived from the frontend + conv geometry (all center=False):
a 100 Hz STFT frame j spans samples [160j, 160j+400) so its center is
0.01*j + 0.0125 s; each k=3/s=2 conv output centers on its middle input,
applied twice, so 25 Hz frame i centers at 0.04*i + 0.0425 s. A boundary "at
frame i" (a chunk starts there) marks the transition FROM frame i-1 — the
midpoint between their centers:

    t(i) = 0.04 * i + 0.0225 s.

Frame 0's boundary is structural (the router forces p_1 = 1) and is excluded;
the utterance-initial true edge is dropped symmetrically. Type B stage-2
boundaries index stage-1's kept frames and map back through stage-1's boundary
vector before timing.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from hnet_mamba_asr_torch.utils.logging_utils import get_logger

logger = get_logger(__name__)

FRAME_PERIOD_S = 0.04                       # 25 Hz encoder frames
BOUNDARY_OFFSET_S = 0.0225                  # transition instant of frame i
DEFAULT_TOL_S = 0.02                        # ±20 ms


def _times_of(indices: Sequence[int]) -> list[float]:
    return [i * FRAME_PERIOD_S + BOUNDARY_OFFSET_S for i in indices]


def frame_boundary_times(b_row: Sequence[float], length: int,
                         drop_first: bool = True) -> list[float]:
    """Binary boundary vector [L] -> transition times in seconds."""
    lo = 1 if drop_first else 0
    hits = np.asarray(b_row[:int(length)], dtype=np.float32) >= 0.5
    return _times_of([i for i in np.nonzero(hits)[0] if i >= lo])


def stage2_boundary_times(b1_row: Sequence[float], b2_row: Sequence[float],
                          length1: int, drop_first: bool = True) -> list[float]:
    """Stage-2 frame j IS stage-1's j-th kept frame: compose the indexing."""
    kept = np.nonzero(np.asarray(b1_row[:int(length1)], np.float32) >= 0.5)[0]
    lo = 1 if drop_first else 0
    picked = [int(kept[j]) for j in range(lo, min(len(b2_row), len(kept)))
              if float(b2_row[j]) >= 0.5]
    return _times_of(picked)


def true_edges(units: Sequence[Sequence], min_t: float = 0.03,
               dedupe_tol: float = 1e-4) -> list[float]:
    """Alignment triples -> sorted internal edge times. Both starts and ends
    count (a pause makes two real edges); abutting duplicates collapse; edges
    near t=0 are the structural utterance onset and are dropped (mirroring
    drop_first on the model side)."""
    raw = sorted(float(t) for _, start, end in units for t in (start, end))
    edges: list[float] = []
    for t in raw:
        if t < min_t:
            continue
        if edges and t - edges[-1] <= dedupe_tol:
            continue
        edges.append(t)
    return edges


@dataclass
class MatchCounts:
    hit: int
    pred: int
    true: int

    def as_tuple(self) -> tuple[int, int, int]:
        return self.hit, self.pred, self.true


def match_boundaries(pred: Sequence[float], true: Sequence[float],
                     tol: float = DEFAULT_TOL_S) -> tuple[int, int, int]:
    """Greedy one-to-one matching on the sorted time axis.

    Two pointers walk both sorted lists; a pair within tolerance consumes both
    sides. (The reference project verified this greedy walk equals brute-force
    optimal assignment on >19k real utterances; our fuzz test reproduces that.)
    """
    ps, ts = sorted(pred), sorted(true)
    slack = tol + 1e-9                       # exact-tol hits survive float repr
    hit = pi = ti = 0
    while pi < len(ps) and ti < len(ts):
        gap = ps[pi] - ts[ti]
        if abs(gap) <= slack:
            hit += 1
            pi += 1
            ti += 1
        elif gap < 0:
            pi += 1
        else:
            ti += 1
    return hit, len(ps), len(ts)


def prf(n_hit: int, n_pred: int, n_true: int) -> dict[str, float]:
    precision = n_hit / n_pred if n_pred else 0.0
    recall = n_hit / n_true if n_true else 0.0
    denom = precision + recall
    return {"precision": precision, "recall": recall,
            "f1": 2 * precision * recall / denom if denom else 0.0}


def r_value(recall: float, over_seg: float) -> float:
    """Räsänen et al. 2009 on fractions: 1 at perfect segmentation, and —
    unlike plain recall — it punishes boundary-spraying."""
    d1 = ((1.0 - recall) ** 2 + over_seg ** 2) ** 0.5
    d2 = (recall - over_seg - 1.0) / (2 ** 0.5)
    return 1.0 - (abs(d1) + abs(d2)) / 2.0


def aggregate(counts: Sequence[tuple[int, int, int]]) -> dict[str, float]:
    """Corpus micro-average of per-utterance (hit, pred, true) counts."""
    arr = np.asarray([tuple(c) for c in counts], dtype=np.int64).reshape(-1, 3)
    hit, pred, true = (int(x) for x in arr.sum(axis=0))
    out = prf(hit, pred, true)
    out["over_seg"] = (pred / true - 1.0) if true else 0.0
    out["r_value"] = r_value(out["recall"], out["over_seg"])
    out.update(n_hit=hit, n_pred=pred, n_true=true, n_utts=len(counts))
    return out


def random_baseline(per_utt: Sequence[Mapping[str, Any]], tol: float = DEFAULT_TOL_S,
                    seed: int = 1, trials: int = 10) -> dict[str, float]:
    """Chance floor: same per-utterance boundary COUNT, positions uniform in
    (0, duration); corpus metrics averaged over seeded trials."""
    rng = random.Random(seed)
    keys = ("precision", "recall", "f1", "r_value", "over_seg")
    acc = dict.fromkeys(keys, 0.0)
    for _ in range(trials):
        trial_counts = []
        for u in per_utt:
            darts = sorted(rng.uniform(0.0, u["duration"])
                           for _ in range(u["n_pred"]))
            trial_counts.append(match_boundaries(darts, u["true"], tol))
        metrics = aggregate(trial_counts)
        for k in keys:
            acc[k] += metrics[k] / trials
    return acc


def score_utterances(boundaries: Mapping[str, Sequence[float]],
                     alignments: Mapping[str, Mapping], tier: str,
                     tol: float = DEFAULT_TOL_S, *, min_t: float = 0.03,
                     durations: Mapping[str, float] | None = None) -> dict:
    """Corpus metrics over the utterances present in BOTH inputs.

    Coverage gaps are reported in both directions; ``durations`` (true audio
    seconds per utterance) sets the random-baseline dart board — omitting it
    ends the board at the last aligned unit, which excludes trailing silence
    and inflates the chance floor a few percent."""
    if tier not in ("words", "phones"):
        raise ValueError(f"tier must be 'words' or 'phones', got {tier!r}")
    only_bounds = sorted(set(boundaries) - set(alignments))
    only_aligns = sorted(set(alignments) - set(boundaries))
    counts, per_utt = [], []
    for uid in sorted(set(boundaries) & set(alignments)):
        units = alignments[uid][tier]
        edges = true_edges(units, min_t=min_t)
        predicted = sorted(boundaries[uid])
        counts.append(match_boundaries(predicted, edges, tol))
        board = max((float(end) for _, _, end in units), default=0.0)
        if durations is not None and uid in durations:
            board = float(durations[uid])
        per_utt.append({"n_pred": len(predicted), "true": edges,
                        "duration": board})
    if not counts:
        raise ValueError("no utterances overlap between boundaries and alignments")
    if only_aligns:                          # the silently-dangerous direction
        logger.warning("%d aligned utterances have no boundaries and are "
                       "excluded from the corpus metric", len(only_aligns))
    result = aggregate(counts)
    result.update(tier=tier, tol_s=tol, missing_alignments=only_bounds,
                  missing_boundaries=only_aligns, _per_utt=per_utt)
    return result


def host_array(value, dtype=np.float32) -> np.ndarray:
    """A tensor (on any device, in any dtype: bf16 too) or an array -> a numpy
    array of ``dtype``. ``np.asarray`` raises on a CUDA or a bf16 tensor."""
    if torch.is_tensor(value):
        value = value.detach().cpu()
        if value.is_floating_point():
            value = value.float()
        value = value.numpy()
    return np.asarray(value, dtype=dtype)


def collect_boundaries(encode_fn, loader) -> dict[int, dict[str, list[float]]]:
    """Run the encoder over a loader -> {stage: {utt id: boundary times}}.

    ``encode_fn(batch) -> EncoderOutput`` (duck-typed: .boundaries [(p, b)...]
    and .lengths, tensors or arrays). Stage 2 maps through stage 1's kept
    frames. Padded batch rows beyond ``ids`` are skipped, and each row is
    read to its own length, so the loader's padding adds nothing.
    """
    collected: dict[int, dict[str, list[float]]] = {}
    for batch in loader:
        ids = batch.get("ids", [])
        enc = encode_fn(batch)
        for stage in range(len(enc.boundaries)):
            collected.setdefault(stage, {})
        lengths = host_array(enc.lengths, np.int64)
        hard = [host_array(b) for _, b in enc.boundaries]
        for row, uid in enumerate(ids):
            L = int(lengths[row])
            collected[0][uid] = frame_boundary_times(hard[0][row], L)
            if len(hard) > 1:
                collected[1][uid] = stage2_boundary_times(hard[0][row],
                                                          hard[1][row], L)
    logger.info("collected boundaries: %d stages, %d utts", len(collected),
                len(next(iter(collected.values()), {})))
    return collected
