"""Interp orchestration: boundary reports, probes, robustness, emergence.
Counterpart of ``hnet_mamba_asr_tpu/interp/driver.py`` (a copy over the
port's data pipeline: ``PerturbedDataset`` is the port's ``ASRDataset``,
reads audio through ``data/audio.py::read_audio`` and speed-perturbs through
the host library's resampler; probe fits take the port's backends, 'torch'
on the card by default).

Capability spec: reference src/dcasr/interp/driver.py (same mandates, same
report schema; the organization here is its own). The audit mandates from the
reference's verification history are enforced structurally:

(a) probe train/test disjointness is asserted on the utterance ids ACTUALLY
    consumed from the loaders — contamination silently inflates accuracy;
(b) every scored utterance must have a TRUE audio duration (the random
    baseline's dart board; the last-unit fallback inflates the floor);
(c) word probes carry their top-k kept fractions on both sides;
(d) a random-baseline floor is computed and stored beside every boundary
    metric block.

Design: all clean-time -> perturbed-time bookkeeping lives in ONE place, a
monotone piecewise-linear ``TimeMap``. A perturbation contributes exactly two
things — a waveform edit and a ``TimeMap`` for a given utterance duration —
and every coordinate transform (truth records, clean boundaries, durations,
sample counts) is derived from that map by the shared base class. Robustness
and clean boundary scoring share one tier-scoring core; probe fitting is a
single closure applied across a task plan.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np

from hnet_mamba_asr_torch.data.audio import apply_speed_perturb, read_audio
from hnet_mamba_asr_torch.data.dataset import ASRDataset
from hnet_mamba_asr_torch.data.manifests import SAMPLE_RATE, feat_frames
from hnet_mamba_asr_torch.interp.boundary_align import (
    DEFAULT_TOL_S, aggregate, collect_boundaries, random_baseline,
    score_utterances,
)
from hnet_mamba_asr_torch.interp.probes import (
    collect_probe_data, subsample, to_classes, top_k_filter, train_probe,
)
from hnet_mamba_asr_torch.utils.logging_utils import get_logger

logger = get_logger(__name__)


def utt_seed(seed: int, uid: str) -> int:
    """Stable per-utterance RNG seed (blake2s digest; python hash() is salted
    per process, so it cannot key reproducible augmentation)."""
    digest = hashlib.blake2s(f"{int(seed)}:{uid}".encode("utf-8"),
                             digest_size=4).digest()
    return int.from_bytes(digest, "big") & 0x7FFFFFFF


# ═══ time geometry ════════════════════════════════════════════════════════════
class TimeMap:
    """Monotone piecewise-linear map from clean-time to perturbed-time.

    Segments are ``(start, scale, offset)`` sorted by start; a time ``t`` maps
    through the last segment whose start it reaches: ``scale * t + offset``.
    Identity / uniform-speed / splice-shift perturbations are all instances,
    so record movement, duration growth, and boundary relocation share one
    implementation instead of per-perturbation ``_t`` overrides.
    """

    IDENTITY_SEGMENTS = ((float("-inf"), 1.0, 0.0),)

    def __init__(self, segments: Sequence[tuple[float, float, float]] =
                 IDENTITY_SEGMENTS):
        self.segments = tuple(segments)

    def __call__(self, t: float) -> float:
        for start, scale, offset in reversed(self.segments):
            if t >= start:
                return scale * t + offset
        return t

    @classmethod
    def identity(cls) -> "TimeMap":
        return cls()

    @classmethod
    def scaled(cls, scale: float) -> "TimeMap":
        return cls(((float("-inf"), float(scale), 0.0),))

    @classmethod
    def shifted_from(cls, cut: float, shift: float) -> "TimeMap":
        """Identity before ``cut``; +``shift`` at and after it (a splice)."""
        return cls(((float("-inf"), 1.0, 0.0), (float(cut), 1.0, float(shift))))


# ═══ perturbations ════════════════════════════════════════════════════════════
class Perturbation:
    """A waveform edit plus its time geometry.

    Subclasses override ``edit_wave`` (the audio effect; ``rng`` is seeded per
    utterance) and ``time_map`` (the clean->perturbed coordinate map for an
    utterance of the given duration). Everything else — truth-record movement,
    duration/sample-count growth, boundary relocation — is derived here.
    """

    kind = "identity"
    name = "identity"

    def edit_wave(self, wave: np.ndarray, rng: np.random.Generator,
                  sample_rate: int) -> np.ndarray:
        return wave

    def time_map(self, duration: float) -> TimeMap:
        return TimeMap.identity()

    # derived surface -----------------------------------------------------------
    def apply_wave(self, wave: np.ndarray, uid: str, *, seed: int = 1,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
        rng = np.random.default_rng(utt_seed(seed, uid))
        return self.edit_wave(wave, rng, sample_rate)

    def transform_times(self, times: Sequence[float],
                        duration: float) -> list[float]:
        tmap = self.time_map(duration)
        return [tmap(float(t)) for t in times]

    def transform_record(self, record: Mapping, duration: float) -> dict:
        """Move every aligned unit's edges into perturbed time."""
        tmap = self.time_map(duration)
        moved = dict(record)
        for tier in ("words", "phones"):
            moved[tier] = [[label, tmap(float(s)), tmap(float(e))]
                           for label, s, e in record[tier]]
        return moved

    def transform_duration(self, duration: float) -> float:
        return self.time_map(duration)(duration)

    def transform_samples(self, n: int) -> int:
        duration = int(n) / SAMPLE_RATE
        return round(self.time_map(duration)(duration) * SAMPLE_RATE)


class NoisePerturbation(Perturbation):
    """White Gaussian noise at a target SNR. Time axis untouched."""

    kind = "noise"

    def __init__(self, snr_db: float):
        self.snr_db = float(snr_db)
        self.name = f"noise_snr{self.snr_db:g}"

    def edit_wave(self, wave, rng, sample_rate):
        signal_power = float(np.mean(np.square(wave)))
        if signal_power <= 0.0:
            return wave
        noise_rms = (signal_power / 10.0 ** (self.snr_db / 10.0)) ** 0.5
        return wave + noise_rms * rng.standard_normal(wave.shape)


class SpeedPerturbation(Perturbation):
    """Playback at factor-x speed via resampling; the time axis contracts
    uniformly by 1/factor."""

    kind = "speed"

    def __init__(self, factor: float):
        if factor <= 0:
            raise ValueError(f"speed factor must be positive, got {factor}")
        self.factor = float(factor)
        self.name = f"speed_{self.factor:g}"

    def edit_wave(self, wave, rng, sample_rate):
        return apply_speed_perturb(wave, sample_rate, self.factor)

    def time_map(self, duration):
        return TimeMap.scaled(1.0 / self.factor)


class SilencePerturbation(Perturbation):
    """Digital silence spliced in at a fraction of the utterance; clean times
    at/after the splice shift right by its duration."""

    kind = "silence"

    def __init__(self, duration_s: float, at_frac: float = 0.5):
        if duration_s <= 0 or not 0.0 <= at_frac <= 1.0:
            raise ValueError("need duration_s > 0 and at_frac in [0, 1], got "
                             f"{duration_s}, {at_frac}")
        self.duration_s = float(duration_s)
        self.at_frac = float(at_frac)
        self.name = f"silence_{self.duration_s:g}s_at{self.at_frac:g}"

    def edit_wave(self, wave, rng, sample_rate):
        cut = round(self.at_frac * len(wave))
        hole = np.zeros(round(self.duration_s * sample_rate), dtype=wave.dtype)
        return np.concatenate([wave[:cut], hole, wave[cut:]])

    def time_map(self, duration):
        return TimeMap.shifted_from(self.at_frac * duration, self.duration_s)

    def window(self, duration: float) -> tuple[float, float]:
        """The inserted-silence interval, in perturbed-time coordinates."""
        begin = self.at_frac * duration
        return begin, begin + self.duration_s


def perturbations_from_config(cfg: Mapping) -> list[Perturbation]:
    """robustness config block -> perturbation list (schema pinned by the
    reference configs: noise_snr_db / speed_factors lists + a silence block,
    where ``silence: null|false`` disables and ``{}``/absent means defaults)."""
    out: list[Perturbation] = []
    out += [NoisePerturbation(snr) for snr in cfg.get("noise_snr_db", (20, 10, 5, 0))]
    out += [SpeedPerturbation(f) for f in cfg.get("speed_factors", (0.9, 1.1))]
    silence_cfg = cfg.get("silence", {})
    if silence_cfg is not None and silence_cfg is not False:
        silence_cfg = silence_cfg or {}
        out.append(SilencePerturbation(float(silence_cfg.get("duration_s", 0.5)),
                                       float(silence_cfg.get("at_frac", 0.5))))
    return out


class PerturbedDataset(ASRDataset):
    """Eval dataset that perturbs the waveform before batching; item lengths
    are recomputed from perturbed sample counts (approximate for speed —
    resampler rounding; the sampler only budgets with them)."""

    def __init__(self, entries, tokenizer, perturbation: Perturbation,
                 seed: int = 1):
        super().__init__(entries, tokenizer, augment=False)
        self.perturbation = perturbation
        self.perturb_seed = int(seed)
        self.samples = [perturbation.transform_samples(e["frames"]) for e in self.entries]
        self.lengths = [feat_frames(n) for n in self.samples]

    def __getitem__(self, i: int) -> dict:
        entry = self.entries[self.items[i][0]]
        wave, _sr = read_audio(entry["audio"])
        wave = self.perturbation.apply_wave(
            wave, entry["id"], seed=self.perturb_seed,
            sample_rate=self.sample_rate)
        return {"wave": wave.astype(np.float32), "n_samples": len(wave),
                "tokens": np.asarray(self.tokenizer.encode(entry["text"]),
                                     dtype=np.int32),
                "id": entry["id"], "index": i}


# ═══ collection bookkeeping ═══════════════════════════════════════════════════
def durations_from_entries(entries: Sequence[Mapping]) -> dict[str, float]:
    return {e["id"]: e["frames"] / SAMPLE_RATE for e in entries}


def assert_disjoint(a: set, b: set, what: str = "probe train/test") -> None:
    shared = set(a) & set(b)
    if shared:
        raise ValueError(
            f"{what} utterance sets overlap: {len(shared)} shared ids "
            f"(e.g. {sorted(shared)[:5]}) — contamination silently inflates "
            "probe accuracy; use disjoint splits")
    logger.info("%s disjointness verified: %d vs %d utts, 0 shared",
                what, len(set(a)), len(set(b)))


class RecordingLoader:
    """Loader proxy accumulating every consumed utterance id in ``.seen``;
    each pass iterates the wrapped loader (a prefetching ``DataLoader`` too)
    once."""

    def __init__(self, loader):
        self.loader = loader
        self.seen: set[str] = set()

    def __iter__(self):
        for batch in self.loader:
            self.seen.update(batch.get("ids", []))
            yield batch


def list_epoch_checkpoints(ckpt_dir: str | Path) -> list[tuple[int, Path]]:
    found = []
    for path in Path(ckpt_dir).glob("epoch*.ckpt"):
        try:
            found.append((int(path.stem[5:]), path))
        except ValueError:
            continue
    if not found:
        raise FileNotFoundError(
            f"no epoch*.ckpt checkpoints under {ckpt_dir} — emergence needs "
            "retained epochs (keep_all_checkpoints: true)")
    return sorted(found)


# ═══ scoring core (shared by boundary + robustness reports) ═══════════════════
def _greedy_walk(pred: Sequence[float], true: Sequence[float],
                 tol: float) -> tuple[list[float], int, int]:
    """One two-pointer walk over both sorted lists -> (signed pred-true
    offsets of the hit pairs, n_pred, n_true). The hit count is
    ``len(offsets)``; the walk is the same greedy matcher boundary_align
    uses, so counts agree with ``match_boundaries``."""
    ps, ts = sorted(float(t) for t in pred), sorted(float(t) for t in true)
    slack = tol + 1e-9
    offsets: list[float] = []
    pi = ti = 0
    while pi < len(ps) and ti < len(ts):
        gap = ps[pi] - ts[ti]
        if abs(gap) <= slack:
            offsets.append(gap)
            pi += 1
            ti += 1
        elif gap < 0:
            pi += 1
        else:
            ti += 1
    return offsets, len(ps), len(ts)


def matched_deltas(pred: Sequence[float], true: Sequence[float],
                   tol: float = DEFAULT_TOL_S) -> list[float]:
    """Signed pred-true offsets of the greedy matcher's hit pairs."""
    return _greedy_walk(pred, true, tol)[0]


def _score_tiers(stage_bounds: Mapping[str, Sequence[float]],
                 truth: Mapping[str, Mapping],
                 durations: Mapping[str, float], *, tol: float,
                 baseline_trials: int, baseline_seed: int,
                 coverage_context: str | None = None) -> dict:
    """words+phones corpus metrics for one stage, floors attached (mandate d).
    With ``coverage_context`` set, aligned utterances missing from the
    boundary collection raise (a partial collection biases the corpus metric)."""
    block: dict = {}
    for tier in ("words", "phones"):
        metrics = score_utterances(stage_bounds, truth, tier, tol,
                                   durations=durations)
        if coverage_context is not None and metrics["missing_boundaries"]:
            raise ValueError(
                f"{coverage_context}: {len(metrics['missing_boundaries'])} "
                "aligned utterances have no boundaries (e.g. "
                f"{metrics['missing_boundaries'][:5]}) — a partial collection "
                "biases the corpus metric")
        metrics["random_baseline"] = random_baseline(
            metrics.pop("_per_utt"), tol, seed=baseline_seed,
            trials=baseline_trials)
        block[tier] = metrics
    return block


def boundary_report(encode_fn, loader, alignments: Mapping[str, Mapping],
                    durations: Mapping[str, float], *, tol: float = DEFAULT_TOL_S,
                    baseline_trials: int = 20, baseline_seed: int = 1,
                    require_coverage: bool = True) -> tuple[dict, dict]:
    """Collect + score boundaries per stage x tier with floors attached."""
    bounds = collect_boundaries(encode_fn, loader)
    if not bounds or not next(iter(bounds.values()), {}):
        raise ValueError("collect_boundaries returned nothing — empty loader?")
    scored_ids = set().union(*bounds.values()) & set(alignments)
    undurated = sorted(scored_ids - set(durations))
    if undurated:
        raise ValueError(f"{len(undurated)} scored utterances lack a true "
                         f"duration (e.g. {undurated[:5]}) — the random "
                         "baseline needs real audio durations")
    report = {
        f"stage{stage_idx}": _score_tiers(
            bounds[stage_idx], alignments, durations, tol=tol,
            baseline_trials=baseline_trials, baseline_seed=baseline_seed,
            coverage_context=f"stage {stage_idx}" if require_coverage else None)
        for stage_idx in sorted(bounds)}
    return report, bounds


# ═══ robustness ═══════════════════════════════════════════════════════════════
def _consistency_block(pert: Perturbation,
                       clean_stage: Mapping[str, Sequence[float]],
                       pert_stage: Mapping[str, Sequence[float]],
                       durations: Mapping[str, float], *, tol: float,
                       context: str) -> dict:
    """Perturbed boundaries vs the time-transformed CLEAN boundaries: did the
    model's own segmentation move? One greedy walk per utterance yields both
    the hit counts (for P/R/F1) and the signed shift magnitudes."""
    overlap = sorted(set(pert_stage) & set(clean_stage) & set(durations))
    if not overlap:
        raise ValueError(f"{context}: no shared utterances between clean and "
                         "perturbed boundary collections")
    counts, shifts = [], []
    for uid in overlap:
        moved_clean = pert.transform_times(clean_stage[uid], durations[uid])
        offs, n_pred, n_true = _greedy_walk(pert_stage[uid], moved_clean, tol)
        counts.append((len(offs), n_pred, n_true))
        shifts.extend(offs)
    block = aggregate(counts)
    block["mean_abs_shift_s"] = float(np.mean(np.abs(shifts))) if shifts else 0.0
    return block


def _silence_window_stats(pert: SilencePerturbation,
                          bounds: Mapping[str, Sequence[float]],
                          durations: Mapping[str, float]) -> dict:
    """Boundary rate strictly INSIDE the inserted-silence window vs overall —
    boundaries inside pure silence track acoustics, not linguistic content
    (the window edges are real speech/silence transitions, not counted)."""
    inside = everywhere = 0
    window_seconds = total_seconds = 0.0
    for uid, times in bounds.items():
        if uid not in durations:
            continue
        lo, hi = pert.window(durations[uid])
        inside += sum(1 for t in times if lo < t < hi)
        everywhere += len(times)
        window_seconds += pert.duration_s
        total_seconds += pert.transform_duration(durations[uid])
    return {"n_in_window": inside, "n_total": everywhere,
            "window_rate_per_s": inside / window_seconds if window_seconds else 0.0,
            "overall_rate_per_s": everywhere / total_seconds if total_seconds else 0.0}


def score_perturbation(pert: Perturbation, clean_bounds: Mapping[int, Mapping],
                       pert_bounds: Mapping[int, Mapping],
                       alignments: Mapping[str, Mapping],
                       durations: Mapping[str, float], *,
                       tol: float = DEFAULT_TOL_S, baseline_trials: int = 10,
                       baseline_seed: int = 1) -> dict:
    """Score perturbed boundaries against (i) the time-transformed truth and
    (ii) the time-transformed CLEAN boundaries (consistency: did they move?)."""
    moved_truth = {uid: pert.transform_record(alignments[uid], durations[uid])
                   for uid in alignments if uid in durations}
    moved_durations = {uid: pert.transform_duration(d)
                       for uid, d in durations.items()}
    out: dict = {}
    for stage_idx in sorted(pert_bounds):
        block = _score_tiers(pert_bounds[stage_idx], moved_truth,
                             moved_durations, tol=tol,
                             baseline_trials=baseline_trials,
                             baseline_seed=baseline_seed)
        block["consistency"] = _consistency_block(
            pert, clean_bounds.get(stage_idx, {}), pert_bounds[stage_idx],
            durations, tol=tol, context=f"stage {stage_idx}")
        if isinstance(pert, SilencePerturbation):
            block["inserted_window"] = _silence_window_stats(
                pert, pert_bounds[stage_idx], durations)
        out[f"stage{stage_idx}"] = block
    return out


def robustness_report(perturbations: Sequence[Perturbation],
                      collect_fn: Callable[[Perturbation], Mapping[int, Mapping]],
                      clean_bounds: Mapping[int, Mapping],
                      alignments: Mapping[str, Mapping],
                      durations: Mapping[str, float], *,
                      tol: float = DEFAULT_TOL_S, baseline_trials: int = 10,
                      baseline_seed: int = 1) -> dict:
    names = [p.name for p in perturbations]
    collisions = sorted({n for n in names if names.count(n) > 1})
    if collisions:
        raise ValueError(f"duplicate perturbation names {collisions} would "
                         "silently overwrite each other's results")
    report = {}
    for pert in perturbations:
        logger.info("robustness: collecting boundaries under %s", pert.name)
        report[pert.name] = score_perturbation(
            pert, clean_bounds, collect_fn(pert), alignments, durations,
            tol=tol, baseline_trials=baseline_trials,
            baseline_seed=baseline_seed)
    return report


# ═══ probes ═══════════════════════════════════════════════════════════════════
def probe_report(encode_fn, train_loader, test_loader,
                 train_alignments: Mapping[str, Mapping],
                 test_alignments: Mapping[str, Mapping], *, n_stages: int,
                 levels: Sequence[str] = ("frames", "chunks"),
                 top_k_words: int = 500, train_cap: int = 50000,
                 test_cap: int = 20000, max_iter: int = 1000, C: float = 1.0,
                 seed: int = 1, backend: str = "torch", device="cuda") -> dict:
    """phone_id / phone_class / word_id probes per representation level;
    ``device`` is the 'torch' backend's (the card by default).

    For word_id the n_collected_* fields count POST-top-k-filter samples;
    phone probes count all labeled samples."""
    bad_levels = set(levels) - {"frames", "chunks"}
    if bad_levels:
        raise ValueError(f"unknown probe levels {sorted(bad_levels)}; "
                         "choose from 'frames', 'chunks'")
    train_loader = RecordingLoader(train_loader)
    test_loader = RecordingLoader(test_loader)
    plan = ([("frames", 0)] if "frames" in levels else []) \
        + ([("chunks", s) for s in range(int(n_stages))]
           if "chunks" in levels else [])
    if not plan:
        raise ValueError(f"no probe levels selected from {levels!r}")

    def gather(tier, level, stage):
        """Both splits for one (tier, level, stage); disjointness (mandate a)
        checked on the ids the loaders ACTUALLY produced this round."""
        train = collect_probe_data(encode_fn, train_loader, train_alignments,
                                   tier, level=level, stage=stage)
        test = collect_probe_data(encode_fn, test_loader, test_alignments,
                                  tier, level=level, stage=stage)
        assert_disjoint(train_loader.seen, test_loader.seen)
        return train, test

    def fit(Xtr, ytr, Xte, yte, **extra):
        collected = (len(ytr), len(yte))
        Xtr, ytr = subsample(Xtr, ytr, train_cap, seed=seed)
        Xte, yte = subsample(Xte, yte, test_cap, seed=seed)
        result = train_probe(Xtr, ytr, Xte, yte, max_iter=max_iter, C=C,
                             seed=seed, backend=backend, device=device)
        result["n_collected_train"], result["n_collected_test"] = collected
        result.update(extra)
        return result

    report: dict = {}
    for level, stage in plan:
        key = "frames" if level == "frames" else f"chunks_s{stage}"
        (Xtr, ytr), (Xte, yte) = gather("phones", level, stage)
        entry = {"phone_id": fit(Xtr, ytr, Xte, yte),
                 "phone_class": fit(Xtr, to_classes(ytr), Xte, to_classes(yte))}
        (Xtr, ytr), (Xte, yte) = gather("words", level, stage)
        Xtr, ytr, train_cov = top_k_filter(Xtr, ytr, top_k_words)
        vocab = set(ytr)
        keep_rows = [i for i, lab in enumerate(yte) if lab in vocab]
        entry["word_id"] = fit(
            Xtr, ytr, [Xte[i] for i in keep_rows], [yte[i] for i in keep_rows],
            top_k=top_k_words, train_kept_fraction=train_cov,
            test_kept_fraction=len(keep_rows) / max(1, len(yte)))
        report[key] = entry
    return report


# ═══ emergence curves ═════════════════════════════════════════════════════════
_CURVE_KEYS = {"precision", "recall", "f1", "r_value", "over_seg", "accuracy",
               "balanced_accuracy", "majority_baseline", "chance",
               "train_kept_fraction", "test_kept_fraction", "mean_abs_shift_s"}


def flatten_metrics(nested: Mapping, prefix: str = "interp") -> dict[str, float]:
    """Nested report -> {slash/joined/key: float} for curve-worthy leaves
    (random-baseline floors included — mandate d)."""
    flat: dict[str, float] = {}
    stack: list[tuple[list[str], Mapping]] = [([prefix], nested)]
    while stack:
        trail, node = stack.pop()
        for key, value in node.items():
            if isinstance(value, Mapping):
                stack.append((trail + [str(key)], value))
            elif key in _CURVE_KEYS and isinstance(value, (int, float)):
                flat["/".join(trail + [str(key)])] = float(value)
    return flat


def emergence_report(make_encode_fn: Callable[[Path], Callable],
                     checkpoints: Sequence[tuple[int, Path]], loader,
                     alignments: Mapping[str, Mapping],
                     durations: Mapping[str, float], *,
                     tol: float = DEFAULT_TOL_S, baseline_trials: int = 10,
                     baseline_seed: int = 1, probe_fn: Callable | None = None,
                     mlogger=None) -> list[dict]:
    """Boundary metrics (+ optional probes) per retained epoch checkpoint;
    ``make_encode_fn(path)`` builds the encoder forward for that checkpoint,
    and scalars land on ``mlogger`` at step == epoch."""
    rows = []
    for epoch, path in checkpoints:
        encode_fn = make_encode_fn(path)
        report, _ = boundary_report(encode_fn, loader, alignments, durations,
                                    tol=tol, baseline_trials=baseline_trials,
                                    baseline_seed=baseline_seed)
        row: dict = {"epoch": int(epoch), "checkpoint": str(path),
                     "boundaries": report}
        if probe_fn is not None:
            row["probes"] = probe_fn(encode_fn)
        if mlogger is not None:
            mlogger.log_scalars(
                flatten_metrics({k: v for k, v in row.items()
                                 if isinstance(v, dict)}),
                step=int(epoch), epoch=int(epoch))
        logger.info("emergence: epoch %d done (%s)", epoch, Path(path).name)
        rows.append(row)
    return rows
