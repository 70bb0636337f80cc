"""Decode-output scoring: corpus WER / CER tables, the paired bootstrap and
the go/no-go gate, counterpart of ``hnet_mamba_asr_tpu/eval/score.py`` (the
port keeps its own copy).

Consumes the per-utterance ``{id, ref, hyp, decode_s, audio_s}`` JSONL
records that ``tasks/decode_task.py`` writes per cell x split. Word error
counts are computed once per utterance and reused for the corpus WER, the
persisted per-utterance counts and the Bisani & Ney paired bootstrap (one
resample-index stream shared by every cell, so pair deltas are exactly
paired; two-sided p-values with the +1 correction). The gate compares the
unrounded WER with a strict ``<`` against
``goal.sane_test_clean_wer_below``.
"""
from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from hnet_mamba_asr_torch.eval.metrics import ErrorStats, levenshtein_counts, normalize_text

logger = logging.getLogger(__name__)

_REQUIRED_KEYS = ("id", "ref", "hyp")


def load_decode_records(path: str | Path) -> list[dict]:
    """Read one cell x split decode JSONL; raise loudly on malformed records,
    missing keys, non-string fields, duplicate ids, or an empty file."""
    out: list[dict] = []
    ids: set[str] = set()
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, start=1):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno} malformed JSON: {e}") from e
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{lineno} record must be an object, "
                                 f"got {type(rec).__name__}")
            for key in _REQUIRED_KEYS:
                if key not in rec:
                    raise ValueError(f"{path}:{lineno} missing {key!r}")
                if not isinstance(rec[key], str):
                    raise ValueError(f"{path}:{lineno} {key!r} must be a string")
            if rec["id"] in ids:
                raise ValueError(f"{path}:{lineno} duplicate utterance id {rec['id']!r}")
            ids.add(rec["id"])
            out.append(rec)
    if not out:
        raise ValueError(f"{path}: no decode records")
    return out


def score_records(records: Sequence[Mapping], normalize: bool = True) -> dict:
    """One cell x split -> corpus WER/CER ErrorStats + per-utt word counts + RTF."""
    norm = normalize_text if normalize else (lambda s: s)
    wer, cer = ErrorStats(), ErrorStats()
    per_utt: list[dict] = []
    decode_s = audio_s = 0.0
    missing_audio = 0
    for rec in records:
        ref_n, hyp_n = norm(rec["ref"]), norm(rec["hyp"])
        rw, hw = ref_n.split(), hyp_n.split()
        s, d, i, c = levenshtein_counts(rw, hw)
        wer.n_ref += len(rw); wer.sub += s; wer.dele += d; wer.ins += i; wer.cor += c
        wer.n_utt += 1; wer.n_correct += int(rw == hw)
        per_utt.append({"id": rec["id"], "n_ref": len(rw), "sub": s, "del": d, "ins": i})
        rc, hc = list(ref_n.replace(" ", "")), list(hyp_n.replace(" ", ""))
        cer.add(rc, hc)
        decode_s += float(rec.get("decode_s", 0.0))
        a = float(rec.get("audio_s", 0.0))
        audio_s += a
        missing_audio += int(a <= 0.0)
    if missing_audio:
        logger.warning("%d/%d records lack positive audio_s — RTF suppressed",
                       missing_audio, len(per_utt))
    rtf = round(decode_s / audio_s, 5) if (audio_s > 0 and not missing_audio) else None
    return {"wer": wer, "cer": cer, "utts": per_utt,
            "decode_s": round(decode_s, 3), "audio_s": round(audio_s, 3), "rtf": rtf}


def cell_summary(scored: Mapping) -> dict:
    """Flat percent numbers for scores.json; ``wer_exact`` is unrounded so the
    gate never decides on a display-rounded value."""
    w: ErrorStats = scored["wer"]
    c: ErrorStats = scored["cer"]
    return {"n_utts": w.n_utt, "n_ref_words": w.n_ref,
            "wer": round(100 * w.er, 2), "wer_exact": 100 * w.er,
            "wer_sub": round(100 * w.sub_rate, 2), "wer_del": round(100 * w.del_rate, 2),
            "wer_ins": round(100 * w.ins_rate, 2),
            "sent_acc": round(100 * w.sentence_acc, 2), "cer": round(100 * c.er, 2),
            "decode_s": scored["decode_s"], "audio_s": scored["audio_s"],
            "rtf": scored["rtf"]}


def check_same_utterances(cells_utts: Mapping[str, Sequence[Mapping]],
                          split: str = "?") -> None:
    """All cells of a split must score identical utterance sets with identical
    reference lengths; zero-reference-word utterances are rejected (WER undefined)."""
    names = list(cells_utts)
    base = {u["id"]: u["n_ref"] for u in cells_utts[names[0]]}
    empty = [uid for uid, n in base.items() if n == 0]
    if empty:
        raise ValueError(f"split {split!r}: zero-reference-word utterance(s) "
                         f"{empty[:5]} — WER is undefined for them")
    for name in names[1:]:
        other = {u["id"]: u["n_ref"] for u in cells_utts[name]}
        if set(other) != set(base):
            raise ValueError(f"split {split!r}: cells {names[0]!r} and {name!r} "
                             "scored different utterance sets")
        mismatched = [uid for uid, n in other.items() if n != base[uid]]
        if mismatched:
            raise ValueError(f"split {split!r}: cells {names[0]!r} and {name!r} disagree "
                             f"on reference length for {mismatched[:5]}")


def bootstrap_split(cells_utts: Mapping[str, Sequence[Mapping]], n_resamples: int = 10000,
                    seed: int = 0, chunk: int = 1000) -> dict:
    """Per-cell WER 95% CIs + all pairwise paired-bootstrap deltas for one split.

    A single resample-index stream is shared by every cell, so each resampled
    corpus is identical across cells and deltas are exactly paired.
    """
    check_same_utterances(cells_utts)
    names = list(cells_utts)
    ordered = {n: sorted(cells_utts[n], key=lambda u: u["id"]) for n in names}
    errs = np.array([[u["sub"] + u["del"] + u["ins"] for u in ordered[n]] for n in names],
                    dtype=np.int64)                              # [cells, utts]
    ref_len = np.array([u["n_ref"] for u in ordered[names[0]]], dtype=np.int64)
    n_utt = ref_len.shape[0]

    rng = np.random.default_rng(seed)
    err_sums = np.empty((len(names), n_resamples), dtype=np.int64)
    ref_sums = np.empty(n_resamples, dtype=np.int64)
    for lo in range(0, n_resamples, chunk):                      # chunked: bounded memory
        hi = min(lo + chunk, n_resamples)
        idx = rng.integers(0, n_utt, size=(hi - lo, n_utt))
        ref_sums[lo:hi] = ref_len[idx].sum(axis=1)
        for ci in range(len(names)):
            err_sums[ci, lo:hi] = errs[ci][idx].sum(axis=1)
    wer_resampled = 100.0 * err_sums / np.maximum(ref_sums, 1)

    wer_full = 100.0 * errs.sum(axis=1) / ref_len.sum()
    cells = {}
    for ci, name in enumerate(names):
        lo95, hi95 = np.percentile(wer_resampled[ci], [2.5, 97.5])
        cells[name] = {"wer": round(float(wer_full[ci]), 2),
                       "wer_ci95": [round(float(lo95), 2), round(float(hi95), 2)]}
    pairs = []
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            deltas = wer_resampled[i] - wer_resampled[j]
            p_le = (np.count_nonzero(deltas <= 0) + 1) / (n_resamples + 1)
            p_ge = (np.count_nonzero(deltas >= 0) + 1) / (n_resamples + 1)
            lo95, hi95 = np.percentile(deltas, [2.5, 97.5])
            pairs.append({"a": names[i], "b": names[j],
                          "delta": round(float(wer_full[i] - wer_full[j]), 2),
                          "delta_ci95": [round(float(lo95), 2), round(float(hi95), 2)],
                          "p_value": round(min(1.0, 2 * min(p_le, p_ge)), 5),
                          "n_resamples": n_resamples})
    return {"cells": cells, "pairs": pairs}


def discover_cells(decode_dir: str | Path) -> dict[str, dict[str, Path]]:
    """Scan the decode output tree (<cell>/<split>.jsonl) -> {split: {cell: path}}."""
    decode_dir = Path(decode_dir)
    if not decode_dir.is_dir():
        raise ValueError(f"decode dir not found: {decode_dir}")
    tree: dict[str, dict[str, Path]] = {}
    for cell_dir in sorted(p for p in decode_dir.iterdir()
                           if p.is_dir() and p.name != "score"):
        for jl in sorted(cell_dir.glob("*.jsonl")):
            tree.setdefault(jl.stem, {})[cell_dir.name] = jl
    if not tree:
        raise ValueError(f"no decode outputs (<cell>/<split>.jsonl) under {decode_dir}")
    return tree


def gate_check(split_cells: Mapping[str, Mapping[str, Mapping]],
               goal_cfg: Mapping | None, gate_split: str = "test-clean",
               gate_cell: str | None = None) -> dict:
    """``goal.sane_test_clean_wer_below`` check: strict ``<`` on the unrounded
    WER; evaluates the pinned cell, else the best (min-WER, ties alphabetical)."""
    threshold = (goal_cfg or {}).get("sane_test_clean_wer_below")
    if threshold is None:
        return {"evaluated": False,
                "reason": "no goal.sane_test_clean_wer_below in config"}
    result = {"evaluated": False, "threshold": float(threshold), "split": gate_split}
    cells = split_cells.get(gate_split)
    if not cells:
        result["reason"] = f"split {gate_split!r} not decoded"
        return result
    exact = {c: s.get("wer_exact", s["wer"]) for c, s in cells.items()}
    if gate_cell is not None:
        if gate_cell not in exact:
            result["reason"] = f"gate cell {gate_cell!r} not decoded on {gate_split!r}"
            return result
        chosen = gate_cell
    else:
        chosen = min(sorted(exact), key=lambda c: exact[c])
    result.update(evaluated=True, cell=chosen, wer=exact[chosen],
                  passed=bool(exact[chosen] < float(threshold)))
    return result


def format_report(splits: Mapping[str, Mapping], gate: Mapping) -> str:
    """Human-readable per-split tables + significance lines + gate verdict."""
    lines: list[str] = []
    for split, block in splits.items():
        cells = block["cells"]
        n = next(iter(cells.values()))["n_utts"] if cells else 0
        lines.append(f"== {split} ({n} utts) ==")
        lines.append(f"{'cell':<16}{'WER':>8}{'Sub':>8}{'Del':>8}{'Ins':>8}"
                     f"{'CER':>8}{'SentAcc':>9}{'RTF':>10}")
        for name, s in cells.items():
            rtf = f"{s['rtf']:.4f}" if s.get("rtf") is not None else "-"
            lines.append(f"{name:<16}{s['wer']:>8.2f}{s['wer_sub']:>8.2f}"
                         f"{s['wer_del']:>8.2f}{s['wer_ins']:>8.2f}{s['cer']:>8.2f}"
                         f"{s['sent_acc']:>9.2f}{rtf:>10}")
        for p in block.get("significance", {}).get("pairs", []):
            mark = "*" if p["p_value"] < 0.05 else " "
            lines.append(f"  {mark} {p['a']} vs {p['b']}: dWER {p['delta']:+.2f} "
                         f"[{p['delta_ci95'][0]:+.2f}, {p['delta_ci95'][1]:+.2f}] "
                         f"p={p['p_value']:.5f}")
        lines.append("")
    if gate.get("evaluated"):
        verdict = "PASS" if gate["passed"] else "FAIL"
        lines.append(f"GATE {verdict}: {gate['cell']} {gate['split']} WER "
                     f"{gate['wer']:.3f} vs < {gate['threshold']:.2f}")
    else:
        lines.append(f"GATE not evaluated: {gate.get('reason', '?')}")
    return "\n".join(lines)


def write_per_utt(utts: Sequence[Mapping], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as w:
        for u in utts:
            w.write(json.dumps(u) + "\n")


def score_decode_dir(decode_dir: str | Path, *, normalize: bool = True,
                     n_bootstrap: int = 10000, seed: int = 0,
                     goal_cfg: Mapping | None = None, gate_split: str = "test-clean",
                     gate_cell: str | None = None) -> dict:
    """Score every cell x split under ``decode_dir``; persist per-utt counts
    under ``score/``; return {"splits": ..., "gate": ...}."""
    decode_dir = Path(decode_dir)
    tree = discover_cells(decode_dir)
    score_dir = decode_dir / "score"
    if score_dir.is_dir():                                   # rerun: no stale per-utt files
        shutil.rmtree(score_dir)
    splits: dict[str, Any] = {}
    for split, cells in tree.items():
        stats, utts = {}, {}
        for cell, path in cells.items():
            scored = score_records(load_decode_records(path), normalize=normalize)
            stats[cell] = cell_summary(scored)
            utts[cell] = scored["utts"]
        check_same_utterances(utts, split)
        for cell in cells:
            write_per_utt(utts[cell], score_dir / cell / f"{split}.jsonl")
        splits[split] = {"cells": stats}
        if n_bootstrap > 0:
            boot = bootstrap_split(utts, n_resamples=n_bootstrap, seed=seed)
            for cell in stats:
                stats[cell]["wer_ci95"] = boot["cells"][cell]["wer_ci95"]
            splits[split]["significance"] = {"pairs": boot["pairs"],
                                             "n_resamples": n_bootstrap, "seed": seed}
    gate = gate_check({s: b["cells"] for s, b in splits.items()}, goal_cfg,
                      gate_split=gate_split, gate_cell=gate_cell)
    return {"splits": splits, "gate": gate}
