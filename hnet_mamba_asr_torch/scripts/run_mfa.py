"""Run the Montreal Forced Aligner (external CLI) and harvest ground truth
(host only).

    python -m hnet_mamba_asr_torch.scripts.run_mfa \
        --manifest manifests/dev-clean.jsonl --out alignments/dev-clean.jsonl \
        [--work-dir alignments/work] [--mfa-bin mfa] [--hours 10 --seed 1]

The JAX package's ``scripts/run_mfa.py``. Pipeline per split: lay the
manifest out as an MFA corpus -> `mfa align` with the english_us_arpa models
-> parse + integrity-check every TextGrid -> alignments JSONL. Rejected and
missing records never enter the ground truth (they are listed in the
.rejected.json sidecar). MFA lives in its own environment; point --mfa-bin
at it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--mfa-bin", default="mfa")
    ap.add_argument("--dictionary", default="english_us_arpa")
    ap.add_argument("--acoustic-model", default="english_us_arpa")
    ap.add_argument("--hours", type=float, default=None,
                    help="optional hours-budget subset (probe train sets)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=4)
    return ap.parse_args(argv)


def run_mfa_align(corpus_dir: Path, out_dir: Path, *, mfa_bin: str, dictionary: str,
                  acoustic_model: str, jobs: int) -> None:
    """Shell out to the MFA CLI; raises on a non-zero exit."""
    cmd = [mfa_bin, "align", str(corpus_dir), dictionary, acoustic_model,
           str(out_dir), "--clean", "--overwrite", "-j", str(jobs)]
    print("+", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"mfa align failed ({res.returncode}):\n{res.stderr[-4000:]}")


def process_split(args) -> None:
    from hnet_mamba_asr_torch.data.audio import load_manifest, write_manifest
    from hnet_mamba_asr_torch.data.manifests import SAMPLE_RATE
    from hnet_mamba_asr_torch.interp.alignments import (
        alignment_record, check_alignment, parse_textgrid, prepare_corpus,
        select_subset, speaker_of, write_alignments,
    )

    entries = load_manifest(args.manifest)
    if args.hours:
        entries = select_subset(entries, args.hours, seed=args.seed)
    work = Path(args.work_dir) if args.work_dir else Path(args.out).parent / "work"
    corpus_dir = work / "corpus"
    tg_dir = work / "textgrids"
    if corpus_dir.exists():
        shutil.rmtree(corpus_dir)
    prepare_corpus(entries, corpus_dir)
    run_mfa_align(corpus_dir, tg_dir, mfa_bin=args.mfa_bin,
                  dictionary=args.dictionary, acoustic_model=args.acoustic_model,
                  jobs=args.jobs)

    records, rejected = [], []
    for e in entries:
        tg = tg_dir / speaker_of(e["id"]) / f"{e['id']}.TextGrid"
        if not tg.exists():
            rejected.append({"id": e["id"], "reason": "no TextGrid produced"})
            continue
        try:
            rec = alignment_record(e["id"], parse_textgrid(tg.read_text()))
            problems = check_alignment(rec, e["text"], e["frames"] / SAMPLE_RATE)
            if problems:
                rejected.append({"id": e["id"], "reason": problems})
                continue
            records.append(rec)
        except ValueError as err:
            rejected.append({"id": e["id"], "reason": str(err)})
    write_alignments(records, args.out)
    side = Path(args.out).with_suffix(".rejected.json")
    side.write_text(json.dumps(rejected, indent=2))
    print(f"alignments: {len(records)} accepted, {len(rejected)} rejected "
          f"-> {args.out} (+ {side.name})")
    if args.hours:
        kept = {r["id"] for r in records}
        sub_manifest = Path(args.out).parent / (Path(args.out).stem + "_manifest.jsonl")
        write_manifest([e for e in entries if e["id"] in kept], sub_manifest)
        print(f"subset manifest -> {sub_manifest}")


if __name__ == "__main__":
    process_split(parse_args())
