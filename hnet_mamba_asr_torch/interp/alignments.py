"""Forced-alignment plumbing: MFA corpus prep, TextGrid parsing, integrity.
Counterpart of ``hnet_mamba_asr_tpu/interp/alignments.py`` (host code; the
port keeps its own copy).

The Montreal Forced Aligner runs as an external CLI (host-side); everything
testable around it lives here (capability spec: reference
src/dcasr/interp/alignments.py): laying a manifest out as an MFA corpus,
seeded hours-budget subsets, a dependency-free TextGrid reader, and per-record
integrity checks feeding boundary_align (±20 ms F1) and probes (labels).

Silence handling: MFA marks silence EXCLUSIVELY with the empty interval label,
so only "" is treated as silence — filtering word-like labels ('sil',
'silence') would delete real words from the ground truth. OOV speech keeps its
word with a single 'spn' phone and is kept here (probes exclude 'spn' later).
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Mapping, Sequence

from hnet_mamba_asr_torch.utils.logging_utils import get_logger

logger = get_logger(__name__)

SAMPLE_RATE = 16000
SILENCE_LABELS = {""}


def speaker_of(utt_id: str) -> str:
    """LibriSpeech id '1272-128104-0000' -> speaker '1272'."""
    return str(utt_id).split("-", 1)[0]


# ── corpus layout ──────────────────────────────────────────────────────────────
def prepare_corpus(entries: Sequence[Mapping], corpus_dir: str | Path) -> int:
    """MFA expects <corpus>/<speaker>/<utt>.<ext> + <utt>.lab transcripts.

    Audio is symlinked (absolute targets — relative ones dangle when MFA
    resolves paths from its own cwd); transcripts are written verbatim."""
    corpus_dir = Path(corpus_dir)
    done: set[str] = set()
    for entry in entries:
        uid = entry["id"]
        if uid in done:
            raise ValueError(f"duplicate utterance id in manifest: {uid!r}")
        done.add(uid)
        src = Path(entry["audio"])
        if not src.is_file():
            raise FileNotFoundError(f"audio missing for {uid}: {src}")
        spk_dir = corpus_dir / speaker_of(uid)
        spk_dir.mkdir(parents=True, exist_ok=True)
        audio_link = spk_dir / (uid + src.suffix)
        if audio_link.is_symlink() or audio_link.exists():
            audio_link.unlink()
        audio_link.symlink_to(src.resolve())
        (spk_dir / (uid + ".lab")).write_text(entry["text"] + "\n",
                                              encoding="utf-8")
    logger.info("prepared MFA corpus: %d utts -> %s", len(done), corpus_dir)
    return len(done)


def select_subset(entries: Sequence[Mapping], hours: float,
                  seed: int = 1) -> list[dict]:
    """Deterministic random subset under an audio-hours budget, id-sorted."""
    if hours <= 0:
        raise ValueError(f"hours must be positive, got {hours}")
    budget = hours * 3600.0
    shuffled = list(entries)
    random.Random(seed).shuffle(shuffled)
    chosen: list[dict] = []
    used = 0.0
    for entry in shuffled:
        seconds = entry["frames"] / SAMPLE_RATE
        if used + seconds > budget and chosen:
            continue
        chosen.append(dict(entry))
        used += seconds
        if used >= budget:
            break
    chosen.sort(key=lambda e: e["id"])
    logger.info("subset: %d utts, %.2f h (budget %.2f h, seed %d)",
                len(chosen), used / 3600, hours, seed)
    return chosen


# ── TextGrid reading (long format; no external deps) ──────────────────────────
@dataclass
class _TierState:
    """Streaming parser state for one `item []` block."""
    name: str | None = None
    xmin: float | None = None
    xmax: float | None = None
    inside_interval: bool = False
    intervals: list = field(default_factory=list)


def _strip_quotes(raw: str) -> str:
    raw = raw.strip()
    if len(raw) >= 2 and raw[0] == '"' and raw[-1] == '"':
        raw = raw[1:-1]
    return raw.replace('""', '"')            # Praat escapes quotes by doubling


def parse_textgrid(text: str) -> dict[str, list[tuple[str, float, float]]]:
    """Long-format TextGrid -> {tier: [(label, xmin, xmax), ...]}.

    Every interval is kept, including empty-label silence — dropping it is the
    caller's decision (see alignment_record). Line-oriented streaming parse:
    `item [n]:` opens a tier, `name =` binds it, `intervals [n]:` opens an
    interval, and xmin/xmax/text key-value lines fill it in.
    """
    if "ooTextFile" not in text[:200] or "TextGrid" not in text[:200]:
        raise ValueError('not a TextGrid (needs File type = "ooTextFile" + '
                         'Object class = "TextGrid" header)')
    tiers: dict[str, list[tuple[str, float, float]]] = {}
    st = _TierState()
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if line.startswith("item") and line.rstrip(":").rstrip().endswith("]"):
            st = _TierState()
            continue
        if line.startswith("intervals ["):
            st.inside_interval = True
            st.xmin = st.xmax = None
            continue
        key, eq, value = line.partition("=")
        if not eq:
            continue
        key = key.strip()
        value = value.strip()
        if key == "name":
            st.name = _strip_quotes(value)
            tiers.setdefault(st.name, [])
            st.inside_interval = False
        elif st.inside_interval and st.name is not None:
            if key == "xmin":
                st.xmin = float(value)
            elif key == "xmax":
                st.xmax = float(value)
            elif key == "text":
                if value.startswith('"') and (len(value) < 2
                                              or not value.endswith('"')):
                    raise ValueError(f"unterminated label in tier {st.name!r} "
                                     "(multi-line labels unsupported)")
                if st.xmin is None or st.xmax is None:
                    raise ValueError("interval text before xmin/xmax in tier "
                                     f"{st.name!r}")
                tiers[st.name].append((_strip_quotes(value), st.xmin, st.xmax))
    if not tiers:
        raise ValueError("no tiers found in TextGrid")
    return tiers


def alignment_record(utt_id: str, tiers: Mapping[str, Sequence], *,
                     drop_silence: bool = True) -> dict:
    """{id, words, phones} with [label, start, end] triples (silence dropped)."""
    record: dict = {"id": utt_id, "words": [], "phones": []}
    for tier in ("words", "phones"):
        record[tier] = [
            [label, round(float(s), 6), round(float(e), 6)]
            for label, s, e in tiers.get(tier, [])
            if not (drop_silence and label in SILENCE_LABELS)]
    if not record["words"] or not record["phones"]:
        raise ValueError(f"{utt_id}: TextGrid lacks words/phones intervals "
                         f"(tiers: {sorted(tiers)})")
    return record


# ── integrity ─────────────────────────────────────────────────────────────────
def _norm_word(w: str) -> str:
    # MFA normalizes edge apostrophes (BUSH' -> bush); compare likewise
    return w.lower().strip("'")


def check_alignment(record: Mapping, text: str, duration_s: float,
                    tol: float = 0.05) -> list[str]:
    """Return integrity problems (empty list == clean): the aligned word
    sequence must equal the transcript, tiers must be monotone and
    non-overlapping, and times must sit inside the audio."""
    issues: list[str] = []
    want = [_norm_word(w) for w in text.split()]
    got = [_norm_word(label) for label, _, _ in record["words"]]
    if got != want:
        where = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                     min(len(want), len(got)))
        issues.append(
            f"word sequence != transcript ({len(got)} vs {len(want)} words; "
            f"first diff at {where}: ref {want[where:where + 1]} vs "
            f"hyp {got[where:where + 1]})")
    for tier in ("words", "phones"):
        horizon = 0.0
        for label, start, end in record[tier]:
            if start < 0:
                issues.append(f"{tier}: negative start {label!r} at {start}")
            if end <= start:
                issues.append(f"{tier}: non-positive interval {label!r} "
                              f"[{start}, {end}]")
            if start < horizon - 1e-6:
                issues.append(f"{tier}: overlap at {label!r} "
                              f"({start} < {horizon})")
            horizon = max(horizon, end)
        if record[tier] and record[tier][-1][2] > duration_s + tol:
            issues.append(f"{tier}: end {record[tier][-1][2]} beyond audio "
                          f"{duration_s:.2f}s")
    return issues


# ── JSONL persistence ─────────────────────────────────────────────────────────
def write_alignments(records: Iterable[Mapping], path: str | Path) -> int:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    count = 0
    with open(path, "w", encoding="utf-8") as sink:
        for record in records:
            sink.write(json.dumps(record) + "\n")
            count += 1
    logger.info("wrote %d alignment records -> %s", count, path)
    return count


def load_alignments(path: str | Path) -> list[dict]:
    with open(path, encoding="utf-8") as src:
        return [json.loads(line) for line in src if line.strip()]
